"""F1P's drain and K5P's batch over pool rows on the CPU: the plain versions
that read only the live blocks (``kernels.fused_mat_pool_plain``, F1P's
materialized slots as pool rows; ``kernels.fused_tree_pool_plain``, the
drain with its edges over those rows; ``kernels.count_batch_tree_pool_plain``)
against the whole-row plain versions, numpy, the JAX package's
``fused_tree`` and ``count_batch_tree`` (``pilosa_tpu/parallel/kernels.py:545``
and ``:255``, through ``apply_prog``'s ``rowb`` leaf) on a one-device CPU
mesh, and at engine level against the reference ``MeshEngine`` with
partial stacks.  Counts, sums, scores and slot words are integers: exact
agreement (tolerance 0).  The CUDA kernels run only on the card
(chip_smoke.py holds them against these plain versions there); here the
wrappers take the plain versions because the tensors are on the CPU."""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pilosa_tpu.parallel import kernels as jk
from pilosa_tpu.parallel.mesh import SHARD_AXIS, put_global
from pilosa_tpu_torch.parallel import kernels

from test_torch_pool_aggregates import build_aggregates, plain
from test_torch_pool_count import BLOCKS, BW, W, make_case, mats_of, mesh1  # noqa: F401
from test_torch_residency import ROW_SHARD, make_sides

FULL = (0, 1, 2, 3)  # the BSI stack's planes (mats[3]): value planes 0..2, then not-null


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


# Slot tables over mats [dense, pool, table, bsi]: rowb leaves, mref chains
# (an xor naming a slot twice, whose references cancel), andnot with a pool
# left side and with an mref one, stack rows beside pool rows, a range leaf,
# a slot whose live word is 0 (row 1 is all zero) and one whose word is
# full (a stack row under an or).
SLOTS = (
    ("and", rb(0), ("row", 0, 1)),
    ("or", ("mref", 0), rb(2)),
    ("xor", ("mref", 1), rb(4), ("mref", 0), ("mref", 0)),
    ("andnot", rb(5), ("row", 0, 0)),
    ("or", ("mref", 2), ("mref", 3), rb(6)),
    ("and", rb(1), rb(0)),
    ("andnot", ("mref", 1), rb(3)),
    ("or", rb(2), ("row", 0, 3)),
    ("and", rb(2), ("range", "gt", 3, FULL, 3, 0)),
)
COUNT_EDGES = [(0, 0), (1, 1), (2, 0), (4, 1), (5, 0), (6, 1), (7, 2), (8, 0)]
AGG_EDGES = [("sum", 1, 0, 3, FULL), ("sum", 5, 1, 3, FULL), ("sum", 7, 1, 3, (0, -1, 2, 3)),
             ("minmax", 3, 1, 3, FULL, True), ("minmax", 4, 0, 3, FULL, False),
             ("topn", 2, 0, 0, 0), ("topnf", 4, 1, 0, 0, 1, 1, 3),
             ("topnf", 8, 0, 0, 0, 1, 1 << 14, None), ("group", 6, 1, (0,), ((0, 1, 3),)),
             ("group", 5, 0, (0, 0), ((2, 1), (0, 3)))]
CASES = [(3, 9), (5, 2), (12, 17), (4, 1)]


def masks_of(S):
    rng = np.random.default_rng(S)
    return [torch.ones(S, dtype=torch.int32),
            torch.from_numpy((rng.random(S) < 0.5).astype(np.int32)),
            torch.zeros(S, dtype=torch.int32)]


def tensors_of(S):
    rng = np.random.default_rng(S + 1)
    idx = torch.tensor([3, 0, 1, 2, 3, 0, 0, 0], dtype=torch.int32)
    return [idx, torch.from_numpy(rng.integers(0, 3 << 15, (len(idx), S)).astype(np.int32))]


def np_live(words):
    """bool[64]: the blocks of uint32[S, W] words that are non-zero in some
    shard."""
    return words.reshape(words.shape[0], BLOCKS, BW).any(axis=(0, 2))


# -- (a) live words and F1P's pool rows ----------------------------------------

def test_slot_live_words_follow_the_rules():
    """live_blocks over a slot table: mref reads the earlier slot's word,
    an xor drops the slots it names an even number of times (as
    compile_fused's mref bit set does), and, and, or and andnot as for a
    tree."""
    case = make_case(3, 4, 9)
    mats = mats_of(*case)
    table = case[1]
    w = [torch.from_numpy(table[r] != 0) for r in range(7)]
    live = []
    for prog in SLOTS:
        live.append(kernels.live_blocks(prog, mats, "cpu", live))
    assert torch.equal(live[0], w[0])
    assert torch.equal(live[1], w[0] | w[2])
    assert torch.equal(live[2], live[1] | w[4])  # mref 0 twice: cancelled
    assert torch.equal(live[3], w[5])
    assert torch.equal(live[4], live[2] | live[3] | w[6])
    assert not live[5].any()
    assert torch.equal(live[6], live[1])
    assert live[7].all()
    assert torch.equal(live[8], w[2])
    assert not kernels.live_blocks(("xor", ("mref", 0), ("mref", 0)), mats, "cpu", live).any()


@pytest.mark.parametrize("S,P_slots", CASES)
def test_fused_mat_pool_plain_holds_each_slot_at_its_live_blocks(S, P_slots):
    case = make_case(S * 13 + P_slots, S, P_slots)
    mats = mats_of(*case)
    masks = masks_of(S)
    spec = kernels.FusedSpec(SLOTS, COUNT_EDGES, AGG_EDGES)
    pool, table = kernels.fused_mat_pool_plain(spec, mats, masks)
    vals = kernels.fused_slots_plain(SLOTS, mats, (S, W), "cpu")
    n_mat = len(spec.mat_slots)
    assert tuple(pool.shape) == (1 + BLOCKS * n_mat, S, BW)
    assert tuple(table.shape) == (n_mat, BLOCKS)
    assert not pool[0].any()
    named = set()
    for r, j in enumerate(spec.mat_slots):
        words = vals[j].numpy().view(np.uint32)
        row = table[r].numpy()
        blocks = np.flatnonzero(row)
        # The table names pool slot 1 + 64 r + b at the slot's live blocks.
        assert np.array_equal(row[blocks], 1 + BLOCKS * r + blocks)
        # Every block where the slot is non-zero is live (the word covers it).
        assert not np.any(np_live(words) & (row == 0))
        # The pool row gathered through its table equals the dense slot.
        got = kernels.pool_row(pool, table[r])
        assert torch.equal(got, vals[j]), (j, S, P_slots)
        named.update((1 + BLOCKS * r + blocks).tolist())
    # Every pool slot the table does not name is zero.
    unnamed = [p for p in range(pool.shape[0]) if p not in named]
    assert not pool[unnamed].any()
    # The dead slot's row names nothing; the full slot's names every block.
    assert not table[spec.mat_slots.index(5)].any()
    assert table[spec.mat_slots.index(7)].all()


@pytest.mark.parametrize("S,P_slots", CASES)
def test_fused_tree_pool_plain_matches_plain(S, P_slots):
    """F1P's drain (counts over live blocks, every edge kind over the pool
    rows through the pool plain versions) against fused_tree_plain."""
    case = make_case(S * 29 + P_slots, S, P_slots)
    mats = mats_of(*case)
    masks = masks_of(S)
    tensors = tensors_of(S)
    spec = kernels.FusedSpec(SLOTS, COUNT_EDGES, AGG_EDGES)
    assert spec.code().pooled
    got = kernels.fused_tree_pool_plain(spec, mats, masks, tensors)
    want = kernels.fused_tree_plain(spec, mats, masks, tensors)
    assert len(got) == len(want) == 1 + sum(kernels.FUSED_ARITY[e[0]] for e in AGG_EDGES)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (i, S, P_slots)
    # The count edges against numpy.
    vals = kernels.fused_slots_plain(SLOTS, mats, (S, W), "cpu")
    for e, (j, m) in enumerate(COUNT_EDGES):
        words = vals[j].numpy().view(np.uint32)[masks[m].numpy() != 0]
        assert int(got[0][e]) == int(np.bitwise_count(words).sum())


def test_edges_over_pool_rows_take_the_pool_plain_versions(monkeypatch):
    """After F1P each Sum and TopN edge reads its slot as the pool row
    ("rowb", 0, 1, i) over [pool, table], the pool plain versions of K6P
    and K3P."""
    from pilosa_tpu_torch.parallel import bsi

    case = make_case(11, 4, 9)
    mats = mats_of(*case)
    masks = masks_of(4)
    calls = []
    for mod, name in ((kernels, "topn_tree_pool_plain"), (kernels, "topn_full_tree_pool_plain"),
                      (bsi, "sum_tree_pool_plain")):
        fn = getattr(mod, name)

        def spy(prog, mats_, *a, _fn=fn, _n=name):
            calls.append((_n, prog, len(mats_)))
            return _fn(prog, mats_, *a)

        monkeypatch.setattr(mod, name, spy)
    spec = kernels.FusedSpec(SLOTS, COUNT_EDGES, AGG_EDGES)
    kernels.fused_tree_pool_plain(spec, mats, masks, tensors_of(4))
    rows = {j: i for i, j in enumerate(spec.mat_slots)}
    assert sorted(c[0] for c in calls) == ["sum_tree_pool_plain"] * 3 + [
        "topn_full_tree_pool_plain"] * 2 + ["topn_tree_pool_plain"]
    assert ("sum_tree_pool_plain", ("rowb", 0, 1, rows[1]), 2) in calls
    assert ("topn_tree_pool_plain", ("rowb", 0, 1, rows[2]), 2) in calls


# -- (b) against the JAX package's fused_tree -----------------------------------

def jax_fused(mesh, spec, case, masks, tensors):
    """The reference fused_tree over the case's numpy operands: stack rows
    as (operand, scalar operand), pool rows as ("rowb", pool operand, slot
    vector operand), the range leaf over its planes with its predicate
    bits, mrefs as they are."""
    from pilosa_tpu.ops import bsi as jbsi

    pool, table, dense, bst = case
    ops, specs = [], []

    def add(arr, spec_):
        ops.append(put_global(mesh, arr, spec_))
        specs.append(spec_)
        return len(ops) - 1

    i_dense, i_pool, i_bsi = (add(a, P(None, SHARD_AXIS)) for a in (dense, pool, bst))
    i_mask = [add(np.where(m.numpy() != 0, 0xFFFFFFFF, 0).astype(np.uint32)[:, None],
                  P(SHARD_AXIS)) for m in masks]

    def conv(p):
        if p[0] == "row":
            return ("row", i_dense, add(np.int32(p[2]), P()))
        if p[0] == "rowb":
            return ("rowb", i_pool, add(table[p[3]], P()))
        if p[0] == "range":
            _, rk, _, planes, lo, _ = p
            return ("range", rk, i_bsi, ("idx", tuple(planes)),
                    add(jbsi.to_bits(lo, len(planes) - 1), P()))
        if p[0] == "mref":
            return p
        return (p[0],) + tuple(conv(q) for q in p[1:])

    jagg = []
    for e in spec.agg_edges:
        kind, j, m = e[0], e[1], i_mask[e[2]]
        if kind == "sum":
            jagg.append(("sum", j, m, i_bsi, ("idx", tuple(e[4]))))
        elif kind == "minmax":
            jagg.append(("minmax", j, m, i_bsi, ("idx", tuple(e[4])), e[5]))
        elif kind == "topn":
            jagg.append(("topn", j, m, i_dense, add(tensors[e[4]].numpy(), P())))
        elif kind == "topnf":
            _, _, _, _, ix, cnt, thr, n_out = e
            jagg.append(("topnf", j, m, i_dense, add(tensors[ix].numpy(), P()),
                         add(tensors[cnt].numpy(), P(None, SHARD_AXIS)),
                         add(np.int32(thr), P()), n_out))
        else:
            jagg.append(("group", j, m, tuple(i_dense for _ in e[3]), tuple(tuple(r) for r in e[4])))
    fspec = (tuple(conv(p) for p in spec.slots),
             tuple((s, i_mask[m]) for s, m in spec.count_edges), tuple(jagg))
    return [np.asarray(x) for x in jk.fused_tree(mesh, fspec, tuple(specs), *ops)]


@pytest.mark.parametrize("kind", ["count", "sum", "minmax", "topn", "topnf", "group"])
def test_fused_pool_drain_matches_reference(mesh1, kind):  # noqa: F811
    """Each edge kind over an F1P pool row, and the count edges, against
    the reference's XLA fused_tree on the same pool, table and rows."""
    S = 5
    case = make_case(40 + len(kind), S, 9)
    mats = mats_of(*case)
    masks = masks_of(S)
    tensors = tensors_of(S)
    aggs = {"count": [], "sum": [AGG_EDGES[0], AGG_EDGES[1]], "minmax": AGG_EDGES[3:5],
            "topn": [AGG_EDGES[5]], "topnf": [AGG_EDGES[6], ("topnf", 5, 0, 0, 0, 1, 1, 8)],
            # The reference takes static row lists that are prefixes only.
            "group": [("group", 6, 1, (0,), ((0, 1, 2),)),
                      ("group", 5, 0, (0, 0), ((0, 1), (0, 1, 2, 3)))]}[kind]
    spec = kernels.FusedSpec(SLOTS[:8], [e for e in COUNT_EDGES if e[0] < 8], aggs)
    got = [x.numpy() for x in kernels.fused_tree_pool_plain(spec, mats, masks, tensors)]
    want = jax_fused(mesh1, spec, case, masks, tensors)
    assert np.array_equal(got[0], want[0])  # the count edges
    at = 1
    for e in aggs:
        if e[0] == "sum":
            assert np.array_equal(got[at], np.concatenate([want[at], [want[at + 1]]]))
            at += 1
            want = want[:at] + want[at + 1:]
        elif e[0] == "minmax":
            vals, n = got[at], got[at + 1]
            assert np.array_equal(n, want[at + 2])
            ref = (want[at].astype(np.int64) << 31) | want[at + 1].astype(np.int64)
            assert np.array_equal(vals[n > 0], ref[n > 0])
            want = want[:at] + want[at + 1:]
            at += 2
        elif e[0] == "topn":
            assert np.array_equal(got[at], want[at]) and np.array_equal(got[at + 1], want[at + 1])
            at += 2
        elif e[0] == "topnf":
            assert np.array_equal(got[at], np.stack(want[at:at + 2]))
            want = want[:at + 1] + want[at + 2:]
            at += 1
        else:
            assert np.array_equal(got[at], want[at])
            at += 1


# -- (c) K5P's plain version ---------------------------------------------------

def batch_trees(rng, n_rows, K):
    """K trees of pool and stack rows (range leaves among them since K5
    takes them), each with a pool leaf, a dead one and a full one among
    them."""
    from test_torch_pool_count import pooled_tree

    out = [("and", rb(1), rb(0)), ("or", rb(2), ("row", 0, 1))]
    while len(out) < K:
        t = pooled_tree(rng, n_rows)
        if kernels.fits(t):
            out.append(t)
    return out[:K]


@pytest.mark.parametrize("S,P_slots,K", [(3, 9, 1), (5, 2, 8), (12, 17, 8), (4, 1, 8),
                                         (6, 9, 64)])
def test_count_batch_pool_plain_matches_plain(S, P_slots, K):
    case = make_case(S * 31 + K, S, P_slots)
    mats = mats_of(*case)
    rng = np.random.default_rng(S + K)
    progs = batch_trees(rng, 6, K)
    masks = np.stack([np.ones(S, bool), np.zeros(S, bool), rng.random(S) < 0.5])
    ids = [int(i) for i in rng.integers(0, 3, K)]
    got = kernels.count_batch_tree_pool_plain(progs, mats, masks, ids, "cpu")
    want = kernels.count_batch_tree_plain(progs, mats, masks, ids, "cpu")
    assert got.dtype == torch.int64 and torch.equal(got, want)
    fan = [K - 1, 0, 0]
    assert torch.equal(kernels.count_batch_tree_pool_plain(progs, mats, masks, ids, "cpu", fan),
                       want[fan])


def jax_count_batch(mesh, progs, mask_ids, case, masks):
    """The reference count_batch_tree over the case's operands: stack rows
    as (operand, scalar operand), pool rows as ("rowb", pool operand, slot
    vector operand), range leaves over the BSI stack as (operand, plane
    gather, predicate bits), zero leaves a zero stack."""
    from pilosa_tpu.ops import bsi as jbsi

    pool, table, dense, bsi = case
    S = dense.shape[1]
    ops, specs = [], []

    def add(arr, spec_):
        ops.append(put_global(mesh, arr, spec_))
        specs.append(spec_)
        return len(ops) - 1

    i_dense, i_pool = add(dense, P(None, SHARD_AXIS)), add(pool, P(None, SHARD_AXIS))
    i_zero = add(np.zeros((1, S, W), np.uint32), P(None, SHARD_AXIS))
    i_bsi = add(bsi, P(None, SHARD_AXIS))
    i_mask = [add(np.where(m[:, None], 0xFFFFFFFF, 0).astype(np.uint32), P(SHARD_AXIS))
              for m in masks]

    def conv(p):
        if p[0] == "row":
            return ("row", i_dense, add(np.int32(p[2]), P()))
        if p[0] == "rowb":
            return ("rowb", i_pool, add(table[p[3]], P()))
        if p[0] == "range":
            _, kind, _, planes, lo, hi = p
            bits = lambda v: add(jbsi.to_bits(v, len(planes) - 1), P())  # noqa: E731
            if kind == "between":
                return ("between", i_bsi, ("gather", tuple(planes)), bits(lo), bits(hi))
            return ("range", kind, i_bsi, ("gather", tuple(planes)), bits(lo))
        if p[0] == "zero":
            return ("zero", i_zero)
        return (p[0],) + tuple(conv(q) for q in p[1:])

    jprogs = tuple((conv(p), i_mask[i]) for p, i in zip(progs, mask_ids))
    return [int(v) for v in np.asarray(jk.count_batch_tree(mesh, jprogs, tuple(specs), *ops))]


@pytest.mark.parametrize("seed", range(2))
def test_count_batch_pool_matches_reference(mesh1, seed):  # noqa: F811
    S = (3, 7)[seed]
    case = make_case(70 + seed, S, (9, 17)[seed])
    mats = mats_of(*case)
    rng = np.random.default_rng(80 + seed)
    progs = batch_trees(rng, 6, 8)
    masks = np.stack([np.ones(S, bool), rng.random(S) < 0.5])
    ids = [k % 2 for k in range(len(progs))]
    got = kernels.count_batch_tree(progs, mats, masks, ids, "cpu")
    assert got.tolist() == jax_count_batch(mesh1, progs, ids, case, masks)


def test_count_batch_routes_a_pooled_batch_to_k5p_plain(monkeypatch):
    calls = []
    fn = kernels.count_batch_tree_pool_plain

    def spy(progs, *a, **k):
        calls.append(len(progs))
        return fn(progs, *a, **k)

    monkeypatch.setattr(kernels, "count_batch_tree_pool_plain", spy)
    case = make_case(5, 3, 9)
    mats = mats_of(*case)
    masks = np.ones((1, 3), bool)
    kernels.count_batch_tree([rb(0), ("and", rb(2), rb(3))], mats, masks, [0, 0], "cpu")
    kernels.count_batch_tree([("row", 0, 0)], mats, masks, [0], "cpu")  # no pool row: K5's
    assert calls == [2]


# -- (d) the wrappers on the card only -------------------------------------------

def test_pool_wrappers_refuse_cpu_tensors():
    case = make_case(9, 3, 9)
    mats = mats_of(*case)
    batch = kernels.compile_batch([rb(0)], [0])
    with pytest.raises(ValueError):
        kernels.count_batch_tree_pool_cuda(batch, mats, np.ones((1, 3), bool), "cpu")
    with pytest.raises(ValueError):  # K5P takes only a batch with a pool row
        kernels.count_batch_tree_pool_cuda(kernels.compile_batch([("row", 0, 0)], [0]), mats,
                                           np.ones((1, 3), bool), "cpu")
    spec = kernels.FusedSpec(SLOTS[:2], [(1, 0)], [])
    gate = torch.ones(3, dtype=torch.int32)
    for fn in (kernels.fused_tree_pool_cuda, kernels.fused_tree_cuda):
        with pytest.raises(ValueError):
            fn(spec.code(), mats, [1], [gate], [1])
    assert kernels.count_batch_tree_pool_cuda.launches == 0
    assert kernels.fused_tree_pool_cuda.launches == 0


# -- (e) engine level: partial stacks beside the reference MeshEngine ----------

SEG = "Intersect(Row(f=10), Row(f=11))"


def drain_entries(pql):
    """A residency drain in small: Counts sharing a pool-row subtree, a Sum
    and a TopN filtered by pool rows, a Min over them."""
    c = lambda q: pql.parse(q).calls[0]  # noqa: E731
    return [
        ({"kind": "count", "call": c(SEG)}, [0, 1, 2]),
        ({"kind": "count", "call": c(f"Union({SEG}, Row(f=12))")}, [0, 2]),
        ({"kind": "sum", "field": "v", "filter": c(SEG)}, [0, 1, 2]),
        ({"kind": "min", "field": "v", "filter": c(f"Union({SEG}, Row(f=12))")}, [0, 1, 2]),
        ({"kind": "topnf", "field": "rt", "src": c("Row(f=11)"), "n": 3, "threshold": 1,
          "row_ids": None}, [0, 1, 2]),
    ]


def test_engine_fused_drain_and_eight_counts_over_pool_rows_match_reference(mesh1, monkeypatch):  # noqa: F811
    calls = []
    fn = kernels.count_batch_tree_pool_plain

    def spy(progs, *a, **k):
        calls.append(len(progs))
        return fn(progs, *a, **k)

    monkeypatch.setattr(kernels, "count_batch_tree_pool_plain", spy)
    sides = make_sides(mesh1, 40 * ROW_SHARD + 4096, build=build_aggregates)
    eight = "".join(f"Count({op}(Row(f={a}), Row(f={b})))" for a, b in ((10, 11), (11, 12))
                    for op in ("Intersect", "Union", "Difference", "Xor"))
    try:
        for s in sides:
            for q in ("Count(Intersect(Row(g=0), Row(g=1)))", "TopN(rt, Row(g=0), n=1)",
                      "Sum(Row(g=0), field=v)", f"Count(Union({SEG}, Row(f=12)))"):
                s.q(q)  # g, rt and v full; f's rows 10-12 requested
            s.flush()
            s.q(f"Count(Union({SEG}, Row(f=12)))")
            s.flush()
        t = sides[1]
        assert t.stack("f").partial and t.stack("f").pool
        fb = [s.engine.host_fallbacks for s in sides]
        got = [plain(s.engine.fused_many("i", drain_entries(s.pql))) for s in sides]
        host = sides[1].host
        want = [host.execute("i", f"Count({SEG})").results[0],
                host.execute("i", f"Count(Union({SEG}, Row(f=12)))", shards=[0, 2]).results[0],
                plain(host.execute("i", f"Sum({SEG}, field=v)").results[0]),
                plain(host.execute("i", f"Min(Union({SEG}, Row(f=12)), field=v)").results[0]),
                plain(host.execute("i", "TopN(rt, Row(f=11), n=3)").results[0])]
        assert got[0] == got[1] == want
        calls.clear()
        res = [s.ex.execute("i", eight).results for s in sides]
        assert res[0] == res[1] == host.execute("i", eight).results
        assert calls == [8]  # one K5P batch (its plain version here)
        assert [s.engine.host_fallbacks for s in sides] == fb
    finally:
        for s in sides:
            s.engine.close()
