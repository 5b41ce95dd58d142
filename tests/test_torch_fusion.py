"""Whole-dashboard fusion in the port (``parallel/fusion.py``, F1
``kernels.fused_tree`` in its plain version, the engine's fused entry
points and plan cache, the batcher's aggregate lane, the executor's
``batched_*`` routing) against the JAX package, on twins built from one
numpy seed: the same drains through the JAX ``MeshEngine.fused_many`` (its
``kernels.fused_tree`` on the CPU mesh) and through the port's, and the
port against its own sequential per-op path.  Every answer is an integer:
exact agreement (tolerance 0).

Data: 3 shards, the dashboard shape of bench.py (``seg`` 4 rows rand |
rand, ``w`` rows 1-4 rand, ``g`` 4 rows rand, the int field ``v`` 0..100)
and a row ``sp=12`` that lives in two occupancy blocks per shard (the
sparse peel), in index ``i``; index ``j`` repeats seg, w and v for
cross-index drains.  The batcher tests hold the drain worker until every
item is queued, so each drain is pooled the same way every run."""

import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu import pql as jpql
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.parallel import kernels as jkernels
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.parallel import fusion, kernels
from pilosa_tpu_torch.parallel.batcher import CountBatcher
from pilosa_tpu_torch.parallel.engine import TorchEngine, UnsupportedLowering

N_SHARDS = 3
SHARDS = list(range(N_SHARDS))
W64 = bitops.WORDS64
SEG = "Intersect(Row(seg=0), Row(seg=1), Row(seg=2), Row(seg=3))"


def _rand(rng, *shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64)


def seeded_data(seed=23):
    """{(index, field): {row: uint64[S, W64]}} and {index: (cols, values)}
    of v: the dashboard of bench.py:1466-1500 at 3 shards."""
    rng = np.random.default_rng(seed)
    rows, vals = {}, {}
    for index in ("i", "j"):
        rows[(index, "seg")] = {r: _rand(rng, N_SHARDS, W64) | _rand(rng, N_SHARDS, W64)
                                for r in range(4)}
        rows[(index, "w")] = {r: _rand(rng, N_SHARDS, W64) for r in range(1, 5)}
        cols = rng.choice(N_SHARDS << 20, 6000, replace=False)
        vals[index] = (cols, cols % 101)
    rows[("i", "g")] = {r: _rand(rng, N_SHARDS, W64) for r in range(4)}
    sp = np.zeros((N_SHARDS, W64), dtype=np.uint64)
    for b in (3, 40):  # two of the 64 occupancy blocks of every shard
        sp.reshape(N_SHARDS, 64, 256)[:, b] = _rand(rng, N_SHARDS, 256)
    rows[("i", "sp")] = {12: sp}
    return rows, vals


def fill(holder, data, FieldOptions):
    rows, vals = data
    for index in ("i", "j"):
        holder.create_index(index)
    for (index, name), by_row in rows.items():
        view = holder.index(index).create_field(name).view_if_not_exists("standard")
        for s in range(N_SHARDS):
            frag = view.fragment_if_not_exists(s)
            for r, words in by_row.items():
                frag.load_row_words(r, words[s].copy())  # the port keeps the array
            frag.cache.invalidate()
    for index, (cols, v) in vals.items():
        holder.index(index).create_field("v", FieldOptions(type="int", min=0, max=100)) \
            .import_values(cols.tolist(), v.tolist())
    return holder


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small torch ops (several
    test workers share a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return seeded_data()


@pytest.fixture(scope="module")
def twins(data):
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    return fill(jh, data, JFieldOptions), fill(th, data, TFieldOptions)


@pytest.fixture(scope="module")
def jeng(twins):
    return MeshEngine(twins[0], make_mesh(8))


@pytest.fixture
def th(data):
    """A port holder of its own, for tests that write."""
    h = THolder(device="cpu")
    h.open()
    return fill(h, data, TFieldOptions)


def _widgets(P, n, seg=SEG, shards=SHARDS):
    """1 segment filter x ``n`` widgets of mixed ops (bench.py _dash_entries)."""
    segc = lambda: P(seg)  # noqa: E731
    return [
        ({"kind": "count", "call": P(f"Intersect({seg}, Row(w=1))")}, shards),
        ({"kind": "sum", "field": "v", "filter": segc()}, shards),
        ({"kind": "topnf", "field": "w", "src": segc(), "n": 5, "threshold": 1,
          "row_ids": None}, shards),
        ({"kind": "min", "field": "v", "filter": segc()}, shards),
        ({"kind": "max", "field": "v", "filter": segc()}, shards),
        ({"kind": "count", "call": P(f"Intersect({seg}, Row(w=2))")}, shards),
        ({"kind": "topn", "field": "w", "rows": [1, 2, 3, 4], "src": segc()}, shards),
        ({"kind": "count", "call": P(f"Difference({seg}, Row(w=3))")}, shards),
        ({"kind": "group", "fields": ["g"], "rows": [[0, 1, 2, 3]], "filter": segc()}, shards),
        ({"kind": "topnf", "field": "w", "src": P(f"Intersect({seg}, Row(w=4))"), "n": 3,
          "threshold": 1, "row_ids": None}, shards),
    ][:n]


def tp(q):
    return tpql.parse(q).calls[0]


def jp(q):
    return jpql.parse(q).calls[0]


def sequential(eng, triples):
    """The port's sequential per-op path, one program per item."""
    return [eng.solo_op(index, spec["kind"], spec, shards) for index, spec, shards in triples]


def same(got, want, shards=SHARDS):
    """One item's result of the port against the reference's (TopN
    scores compared by shard position: the JAX mesh pads the shard axis)."""
    if isinstance(want, tuple) and len(want) == 3 and isinstance(want[0], np.ndarray):
        for s in shards:
            assert np.array_equal(got[0][got[2][s]], want[0][want[2][s]]), s
            assert int(got[1][got[2][s]]) == int(np.asarray(want[1])[want[2][s]]), s
    elif isinstance(want, np.ndarray):
        assert np.array_equal(np.asarray(got), want)
    else:
        assert got == want


def same_all(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        try:
            same(g, w)
        except AssertionError as e:
            raise AssertionError(f"item {k}: {g!r} != {w!r}") from e


# -- fused_tree_plain against the XLA fused_tree --------------------------------

S8 = 8  # the CPU mesh's shard axis: the kernel test's stacks fill it
DEPTH = 7


def _rand_flat_slots(rng, n_slots):
    """A flat slot table over rows of stacks 0 and 1 and earlier slots."""
    ops = ("and", "or", "andnot", "xor")
    slots = []
    for k in range(n_slots):
        kids = []
        for _ in range(int(rng.integers(1, 4))):
            if k and rng.random() < 0.5:
                kids.append(("mref", int(rng.integers(0, k))))
            else:
                kids.append(("row", int(rng.integers(0, 2)), int(rng.integers(0, 6))))
        slots.append(kids[0] if len(kids) == 1 and kids[0][0] == "row"
                     else (ops[int(rng.integers(0, 4))],) + tuple(kids))
    return tuple(slots)


@pytest.mark.parametrize("kind", ["count", "sum", "minmax", "topn", "topnf", "group"])
def test_fused_tree_plain_matches_jax_kernel(kind):
    """A random slot table with mref chains, two count edges and one
    aggregate edge of ``kind``: the port's plain F1 and edge versions
    against the reference's XLA fused_tree, output for output."""
    from jax.sharding import PartitionSpec as P

    from pilosa_tpu.parallel.mesh import SHARD_AXIS, put_global

    rng = np.random.default_rng(31 + len(kind))
    W = bitops.WORDS
    a, b = (rng.integers(0, 1 << 32, (6, S8, W), dtype=np.uint64).astype(np.uint32)
            for _ in range(2))
    planes = rng.integers(0, 1 << 32, (DEPTH + 1, S8, W), dtype=np.uint64).astype(np.uint32)
    cand = rng.integers(0, 1 << 32, (8, S8, W), dtype=np.uint64).astype(np.uint32)
    masks = [np.ones(S8, bool), rng.random(S8) < 0.5]
    ix = np.asarray([5, 0, 7, 2, 2, 1], dtype=np.int32)
    cnt = rng.integers(0, 3, (len(ix), S8)).astype(np.int32)
    slots = _rand_flat_slots(rng, 6)
    count_edges = [(5, 0), (int(rng.integers(0, 6)), 1)]
    j = int(rng.integers(0, 6))
    port_agg = {
        "count": [],
        "sum": [("sum", j, 1, 2, tuple(range(DEPTH + 1)))],
        "minmax": [("minmax", j, 1, 2, tuple(range(DEPTH + 1)), True)],
        "topn": [("topn", j, 1, 3, 0)],
        "topnf": [("topnf", j, 0, 3, 0, 1, 1, 4)],
        "group": [("group", j, 1, (0, 1), ((0, 1, 2), (0, 1)))],
    }[kind]

    # The reference: operands as its engine lowers them.
    mesh = make_mesh(8)
    ops, specs = [], []

    def add(arr, spec):
        ops.append(put_global(mesh, arr, spec))
        specs.append(spec)
        return len(ops) - 1

    i_mat = [add(m, P(None, SHARD_AXIS)) for m in (a, b, planes, cand)]
    i_row = {r: add(np.int32(r), P()) for r in range(6)}
    i_mask = [add(np.where(m, 0xFFFFFFFF, 0).astype(np.uint32)[:, None], P(SHARD_AXIS))
              for m in masks]

    def jslot(p):
        if p[0] == "row":
            return ("row", i_mat[p[1]], i_row[p[2]])
        if p[0] == "mref":
            return p
        return (p[0],) + tuple(jslot(q) for q in p[1:])

    jagg = []
    for e in port_agg:
        if e[0] == "sum":
            jagg.append(("sum", j, i_mask[1], i_mat[2], ("slice", 0, DEPTH + 1)))
        elif e[0] == "minmax":
            jagg.append(("minmax", j, i_mask[1], i_mat[2], ("slice", 0, DEPTH + 1), True))
        elif e[0] == "topn":
            jagg.append(("topn", j, i_mask[1], i_mat[3], add(ix, P())))
        elif e[0] == "topnf":
            jagg.append(("topnf", j, i_mask[0], i_mat[3], add(ix, P()),
                         add(cnt, P(None, SHARD_AXIS)), add(np.int32(1), P()), 4))
        else:
            jagg.append(("group", j, i_mask[1], (i_mat[0], i_mat[1]), ((0, 1, 2), (0, 1))))
    fspec = (tuple(jslot(p) for p in slots), tuple((s, i_mask[m]) for s, m in count_edges),
             tuple(jagg))
    want = [np.asarray(x) for x in jkernels.fused_tree(mesh, fspec, tuple(specs), *ops)]

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32))  # noqa: E731
    spec = kernels.FusedSpec(slots, count_edges, port_agg)
    got = [x.numpy() for x in kernels.fused_tree_plain(
        spec, [t(a), t(b), t(planes), t(cand)],
        [torch.from_numpy(m.astype(np.int32)) for m in masks],
        [torch.from_numpy(ix), torch.from_numpy(cnt)])]
    assert np.array_equal(got[0], want[0])  # the count edges
    if kind == "sum":
        assert np.array_equal(got[1], np.concatenate([want[1], [want[2]]]))
    elif kind == "minmax":
        vals, n = got[1], got[2]
        assert np.array_equal(n, want[3])
        ref = (want[1].astype(np.int64) << 31) | want[2].astype(np.int64)
        assert np.array_equal(vals[n > 0], ref[n > 0])
    elif kind in ("topn", "topnf"):
        assert np.array_equal(got[1], want[1] if kind == "topn" else np.stack(want[1:]))
        if kind == "topn":
            assert np.array_equal(got[2], want[2])
    elif kind == "group":
        assert np.array_equal(got[1], want[1])
    assert len(got) == 1 + sum(kernels.FUSED_ARITY[e[0]] for e in port_agg)


def _run_code(code, mats, shape):
    """F1's evaluation of a compiled slot table (``kernels.FusedCode``),
    step for step as csrc/fused_tree.cu does it, in torch ops: each slot
    from its first item (or ANDNOT's left side, or the op's identity), then
    its items, then the earlier slots of its reference bit set."""
    comb = {kernels.OP_AND: torch.bitwise_and, kernels.OP_OR: torch.bitwise_or,
            kernels.OP_ANDNOT: lambda a, b: a & ~b, kernels.OP_XOR: torch.bitwise_xor}
    zero = torch.zeros(shape, dtype=torch.int32)

    def item(c, v):
        op, arg = c & 0xFF, c >> 8
        if op == kernels.OP_LEAF:
            m, r = code.leaves[arg]
            return mats[m][r]
        if op == kernels.OP_MREF:
            return v[arg]
        assert op == kernels.OP_ZERO
        return zero

    v = []
    for k, op in enumerate(code.op):
        items = code.items[code.item_off[k]: code.item_off[k] + code.item_len[k]]
        if code.first[k] >= 0:
            acc = item(code.first[k], v)
        elif items:
            acc, items = item(items[0], v), items[1:]
        else:
            acc = zero - 1 if op == kernels.OP_AND else zero
        for c in items:
            acc = comb[op](acc, item(c, v))
        for q in range(k):
            if code.mref[k] >> q & 1:
                acc = comb[op](acc, v[q])
        v.append(acc)
    return v


@pytest.mark.parametrize("seed", range(4))
def test_compile_fused_matches_slot_table(seed):
    """F1's compiled form (slots that read no slot first, one-row slots no
    edge reads compiled into their readers, xor references by parity)
    gives every kept slot the value the slot table defines."""
    rng = np.random.default_rng(100 + seed)
    mats = [torch.from_numpy(rng.integers(0, 1 << 32, (6, 2, 64), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)) for _ in range(2)]
    slots = _rand_flat_slots(rng, 12)
    slots = slots[:3] + (("row", 1, 5), ("xor", ("mref", 3), ("mref", 3), ("mref", 0)),
                         ("andnot", ("mref", 3), ("row", 0, 1), ("zero",))) + slots[3:]
    slots = tuple(_shift_refs(p, 3, 3) if i >= 6 else p for i, p in enumerate(slots))
    want = kernels.fused_slots_plain(slots, mats, (2, 64), torch.device("cpu"))
    for keep in (None, frozenset({len(slots) - 1}), frozenset(range(0, len(slots), 3))):
        code = kernels.compile_fused(slots, keep)
        got = _run_code(code, mats, (2, 64))
        for j in range(len(slots)) if keep is None else keep:
            assert code.pos[j] >= 0
            assert torch.equal(got[code.pos[j]], want[j]), (keep, j)
        if keep is not None:
            assert len(code.op) < len(slots) or not any(
                p[0] == "row" for j, p in enumerate(slots) if j not in keep)


def _shift_refs(p, at, by):
    """A slot prog with references to slots >= ``at`` moved up by ``by``."""
    if p[0] == "mref":
        return ("mref", p[1] + by if p[1] >= at else p[1])
    if p[0] in ("and", "or", "andnot", "xor"):
        return (p[0],) + tuple(_shift_refs(q, at, by) for q in p[1:])
    return p


# -- drains through the engines --------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8, 10])
def test_fused_mixed_drain_matches_jax(twins, jeng, n):
    """The dashboard of n widgets: the port's fused drain against the JAX
    fused drain and against the port's sequential per-op path."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    want = jeng.fused_many("i", _widgets(jp, n))
    got = eng.fused_many("i", _widgets(tp, n))
    same_all(got, want)
    same_all(got, sequential(eng, [("i", sp, sh) for sp, sh in _widgets(tp, n)]))
    assert eng.fused_programs == 1


def test_fused_per_query_shard_subsets(twins, jeng):
    """Each item applies its own shard set inside the fused drain."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")

    def entries(P):
        return [
            ({"kind": "count", "call": P(f"Intersect({SEG}, Row(w=1))")}, [0, 2]),
            ({"kind": "sum", "field": "v", "filter": P(SEG)}, [1, 2]),
            ({"kind": "min", "field": "v", "filter": P(SEG)}, SHARDS),
            ({"kind": "topnf", "field": "w", "src": P(SEG), "n": 2, "threshold": 1,
              "row_ids": None}, [1]),
            ({"kind": "group", "fields": ["g"], "rows": [[0, 3]], "filter": P(SEG)}, [0]),
        ]

    same_all(eng.fused_many("i", entries(tp)), jeng.fused_many("i", entries(jp)))


def test_fused_shared_mask_evaluated_once(twins, jeng):
    """The 10-widget dashboard evaluates each distinct subtree once: the
    port's mask counters equal the reference's, and the masks referenced
    exceed those evaluated."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    je = MeshEngine(twins[0], jeng.mesh)
    eng.fused_many("i", _widgets(tp, 10))
    je.fused_many("i", _widgets(jp, 10))
    distinct = set()
    for spec, _ in _widgets(tp, 10):
        distinct |= fusion.item_texts(spec)
    assert eng.fused_masks_evaluated == len(distinct) == je.fused_masks_evaluated
    assert eng.fused_masks_referenced == je.fused_masks_referenced > eng.fused_masks_evaluated
    assert eng.fused_program_queries == je.fused_program_queries == 10


def test_fused_sparse_mask_peels_per_mask(twins, jeng):
    """An unshared Count on the block-clustered row peels onto the sparse
    path (bytes skipped) while its drain-mates stay fused; the same row
    shared with a Sum stays in the fused program."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")

    def entries(P, shared):
        e = [({"kind": "count", "call": P("Row(sp=12)")}, SHARDS),
             ({"kind": "sum", "field": "v", "filter": P(SEG)}, SHARDS),
             ({"kind": "count", "call": P(f"Intersect({SEG}, Row(w=1))")}, SHARDS)]
        if shared:
            e[1] = ({"kind": "sum", "field": "v", "filter": P("Row(sp=12)")}, SHARDS)
        return e

    got = eng.fused_many("i", entries(tp, False))
    assert eng.sparse_dispatches == 1 and eng.device_bytes_skipped > 0
    same_all(got, jeng.fused_many("i", entries(jp, False)))
    got = eng.fused_many("i", entries(tp, True))
    assert eng.sparse_dispatches == 1  # shared: no peel
    same_all(got, jeng.fused_many("i", entries(jp, True)))


def test_fused_error_item_isolated(twins):
    """One bad item (an unknown field) fails alone; its drain-mates answer."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    fd = eng.fused_many_async("i", [
        ({"kind": "count", "call": tp("Row(nope=1)")}, SHARDS),
        ({"kind": "sum", "field": "v", "filter": tp(SEG)}, SHARDS),
    ])
    assert isinstance(fd.errors[0], UnsupportedLowering)
    assert fd.errors[1] is None
    parts = fusion.unpack(fd.dev.numpy(), fd.layout)
    assert fd.decoders[1](parts) == eng.sum("i", "v", tp(SEG), SHARDS)


def test_fused_missing_bsi_field_empty_result(twins, jeng):
    """Sum and Max over a set field give (0, 0), as the reference's drain."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")

    def entries(P):
        return [({"kind": "sum", "field": "w", "filter": P(SEG)}, SHARDS),
                ({"kind": "count", "call": P(SEG)}, SHARDS),
                ({"kind": "max", "field": "nope", "filter": P(SEG)}, SHARDS),
                ({"kind": "sum", "field": "v", "filter": P(SEG)}, SHARDS)]

    got = eng.fused_many("i", entries(tp))
    assert got[0] == (0, 0) and got[2] == (0, 0)
    same_all(got, jeng.fused_many("i", entries(jp)))


def test_fused_plan_cache_hits_across_arrival_orders(twins):
    """The plan cache keys on the canonical order: a permuted arrival is a
    pure hit, and the decoders map back to arrival order."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    base = _widgets(tp, 6)
    want = eng.fused_many("i", base)
    assert (eng.fused_plan_hits, eng.fused_plan_misses) == (0, 1)
    perm = [base[k] for k in (4, 0, 5, 2, 1, 3)]
    same_all(eng.fused_many("i", perm), [want[k] for k in (4, 0, 5, 2, 1, 3)])
    assert (eng.fused_plan_hits, eng.fused_plan_misses) == (1, 1)


@pytest.mark.parametrize("write", ["in_place", "rebuild"])
def test_fused_plan_cache_invalidated_by_writes(th, write):
    """A write the stack syncs in place, and one that rebuilds it (a new
    row), both move the stack's version token: the cached plan rebuilds and
    the answers are the new ones."""
    eng = TorchEngine(th, device="cpu")
    base = _widgets(tp, 10)
    eng.fused_many("i", base)
    reb0, upd0 = eng.stack_rebuilds, eng.stack_updates
    seg = th.index("i").field("seg")
    col = 1 * bitops.SHARD_WIDTH + 77
    if write == "in_place":
        for r in range(4):
            seg.set_bit(r, col)
        th.index("i").field("w").set_bit(1, col)
    else:
        seg.set_bit(9, col)  # a new row: the stack is rebuilt
    got = eng.fused_many("i", base)
    assert eng.fused_plan_misses == 2
    if write == "in_place":
        assert eng.stack_updates > upd0 and eng.stack_rebuilds == reb0
    else:
        assert eng.stack_rebuilds > reb0
    fresh = TorchEngine(th, device="cpu")
    same_all(got, sequential(fresh, [("i", sp, sh) for sp, sh in base]))


def _cross(P):
    """bench.py's cross-index drain over indexes i and j."""
    segc = lambda: P(SEG)  # noqa: E731
    return [
        ("i", {"kind": "count", "call": P(f"Intersect({SEG}, Row(w=1))")}, SHARDS),
        ("j", {"kind": "count", "call": P(f"Intersect({SEG}, Row(w=1))")}, SHARDS),
        ("i", {"kind": "topnf", "field": "w", "src": segc(), "n": 5, "threshold": 1,
               "row_ids": None}, SHARDS),
        ("j", {"kind": "sum", "field": "v", "filter": segc()}, SHARDS),
        ("i", {"kind": "group", "fields": ["g"], "rows": [[0, 1, 2, 3]], "filter": segc()},
         SHARDS),
        ("j", {"kind": "topnf", "field": "w", "src": segc(), "n": 5, "threshold": 1,
               "row_ids": None}, SHARDS),
    ]


def test_cross_index_drain_matches_jax(twins, jeng):
    """One drain over two indexes: one part per index, each exact against
    the JAX cross-index drain, and one program counted."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    got = eng.fused_drain(_cross(tp))
    same_all(got, jeng.fused_drain(_cross(jp)))
    same_all(got, sequential(eng, _cross(tp)))
    assert eng.fused_programs == 1


def test_cross_index_plan_cached_and_invalidated(th):
    """The cross-index plan is cached like a single-index one, and a write
    to either index rebuilds it."""
    eng = TorchEngine(th, device="cpu")
    want = eng.fused_drain(_cross(tp))
    same_all(eng.fused_drain(_cross(tp)), want)
    assert (eng.fused_plan_hits, len(eng._fused_plans)) == (1, 1)
    th.index("j").field("w").set_bit(1, 2 * bitops.SHARD_WIDTH + 5)
    for r in range(4):
        th.index("j").field("seg").set_bit(r, 2 * bitops.SHARD_WIDTH + 5)
    got = eng.fused_drain(_cross(tp))
    assert eng.fused_plan_misses == 2
    same_all(got, sequential(TorchEngine(th, device="cpu"), _cross(tp)))


def test_footprint_weights_match_reference(twins, jeng):
    """The per-item device-cost weights (reduce rows plus each reachable
    slot's rows split among its sharers) equal the reference's."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    fd = eng.fused_many_async("i", _widgets(tp, 8))
    jfd = jeng.fused_many_async("i", _widgets(jp, 8))
    assert fd.weights == pytest.approx(jfd.weights, abs=0)


def test_f1_limits_decline_to_per_op_programs(twins):
    """A drain past F1's slot limit runs its items on their per-op programs,
    counted in fused_declines, with the same answers."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    entries = [({"kind": "count", "call": tp(
        f"Intersect({SEG}, Row(w={1 + k % 4}), Row(g={k // 4}))")}, SHARDS) for k in range(16)]
    entries.append(({"kind": "sum", "field": "v", "filter": tp(SEG)}, SHARDS))
    part = fusion.build(eng, [("i", sp, sh) for sp, sh in entries]).parts[0]
    code = kernels.FusedSpec(part.slots, part.count_edges, part.agg_edges).code()
    assert len(code.op) == 17 > kernels.MAX_FUSED_SLOTS  # 16 counted nodes and the segment
    got = eng.fused_many("i", entries)
    assert eng.fused_declines >= 1 and eng.fused_programs == 0
    same_all(got, sequential(eng, [("i", sp, sh) for sp, sh in entries]))
    with pytest.raises(ValueError):
        kernels.check_fused(code)
    # A slot reference outside a fused program is refused before any launch.
    with pytest.raises(ValueError):
        kernels.check_prog(kernels.compile_prog(("and", ("row", 0, 0), ("mref", 0))))
    with pytest.raises(ValueError):
        kernels.compile_fused((("row", 0, 0), ("and", ("mref", 1), ("row", 0, 1))))


# -- the batcher's aggregate lane --------------------------------------------------


def _held(eng):
    """A batcher whose workers start only when ``release`` is called: every
    submit queues (a permanently hot window), so a drain holds exactly the
    items submitted before the release."""
    b = eng._batcher = CountBatcher(eng)
    b._last_fused = time.monotonic() + 10_000
    b._workers_started = True

    def release(n, timeout=60.0):
        deadline = time.monotonic() + timeout
        while len(b._queue) < n:
            assert time.monotonic() < deadline, "items never queued"
            time.sleep(0.005)
        with b._lock:
            b._workers_started = False
            b._ensure_workers()
            b._cond.notify_all()

    return b, release


def _run(calls):
    """Run each (name, fn) on its own thread; {name: result or exception}."""
    out = {}

    def go(name, fn):
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001
            out[name] = e

    threads = [threading.Thread(target=go, args=c) for c in calls]
    for t in threads:
        t.start()
    return threads, out


def _join(threads):
    for t in threads:
        t.join(60)
        assert not t.is_alive()


def test_batcher_heterogeneous_drain(twins):
    """A Count sharing the segment, a Sum, a Min, a full TopN and a GroupBy
    submitted together drain into one fused program, each exact."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    eng.result_memo.maxsize = 0
    want = sequential(eng, [("i", sp, sh) for sp, sh in _widgets(tp, 9)])
    b, release = _held(eng)
    calls = [
        ("count", lambda: b.submit("i", tp(f"Intersect({SEG}, Row(w=1))"), SHARDS)),
        ("sum", lambda: eng.batched_sum("i", "v", tp(SEG), SHARDS)),
        ("min", lambda: eng.batched_min_max("i", "v", tp(SEG), SHARDS, True)),
        ("tf", lambda: eng.batched_topn_full("i", "w", tp(SEG), SHARDS, 5, 1)),
        ("group", lambda: eng.batched_group_counts("i", ["g"], [[0, 1, 2, 3]], tp(SEG), SHARDS)),
    ]
    threads, out = _run(calls)
    release(len(calls))
    _join(threads)
    assert out["count"] == want[0] and out["sum"] == want[1] and out["min"] == want[3]
    assert out["tf"] == want[2]
    assert np.array_equal(out["group"], want[8])
    assert eng.fused_programs == 1 and eng.fused_program_queries == 5
    eng.close()


def test_batcher_memo_hit_rider(twins):
    """A repeat Sum answers from the memo at submit time; its drain-mates
    fuse without it."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    first = eng.batched_sum("i", "v", tp(SEG), SHARDS)  # idle: direct, stored
    hits0 = eng.result_memo.hits
    b, release = _held(eng)
    calls = [("sum", lambda: eng.batched_sum("i", "v", tp(SEG), SHARDS)),
             ("max", lambda: eng.batched_min_max("i", "v", tp(SEG), SHARDS, False)),
             ("tf", lambda: eng.batched_topn_full("i", "w", tp(SEG), SHARDS, 3, 1))]
    threads, out = _run(calls)
    release(2)
    _join(threads)
    assert out["sum"] == first and eng.result_memo.hits > hits0
    assert out["max"] == eng.min_max("i", "v", tp(SEG), SHARDS, False)
    assert out["tf"] == eng.topn_full("i", "w", tp(SEG), SHARDS, 3, 1)
    assert eng.fused_program_queries == 2
    eng.close()


def test_batcher_solo_aggregate_on_its_program(twins):
    """A drain that holds one aggregate runs it on its own program (K6),
    not a fused program of one item."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    want = eng.sum("i", "v", tp(SEG), SHARDS)
    b, release = _held(eng)
    threads, out = _run([("sum", lambda: eng.batched_sum("i", "v", tp(SEG), SHARDS))])
    release(1)
    _join(threads)
    assert out["sum"] == want
    assert eng.fused_programs == 0 and b.batches == 1
    eng.close()


def test_batcher_direct_path_idle_aggregate(twins):
    """A lone aggregate on an idle batcher runs its program directly: no
    queue, no worker, the same answer."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    eng._batcher = CountBatcher(eng)
    got = eng.batched_min_max("i", "v", tp(SEG), SHARDS, False)
    assert got == eng.min_max("i", "v", tp(SEG), SHARDS, False)
    got = eng.batched_topn_scores("i", "w", [1, 2, 9], tp(SEG), SHARDS)
    want = eng.topn_scores("i", "w", [1, 2, 9], tp(SEG), SHARDS)
    same(got, want)
    assert eng.fused_programs == 0 and not eng._batcher._workers_started
    eng.close()


def test_batcher_bad_op_isolated_from_drain(twins):
    """An aggregate whose filter has no lowering fails alone; the fused
    drain-mates still answer."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    eng.result_memo.maxsize = 0
    b, release = _held(eng)
    calls = [("bad", lambda: eng.batched_sum("i", "v", tp("Row(missing_field=1)"), SHARDS)),
             ("sum", lambda: eng.batched_sum("i", "v", tp(SEG), SHARDS)),
             ("min", lambda: eng.batched_min_max("i", "v", tp(SEG), SHARDS, True))]
    threads, out = _run(calls)
    release(len(calls))
    _join(threads)
    assert isinstance(out["bad"], UnsupportedLowering)
    assert out["sum"] == eng.sum("i", "v", tp(SEG), SHARDS)
    assert out["min"] == eng.min_max("i", "v", tp(SEG), SHARDS, True)
    assert eng.fused_programs == 1
    eng.close()


# -- the executor ------------------------------------------------------------------

DASH_QUERIES = [
    f"Count(Intersect({SEG}, Row(w=1)))",
    f"Sum({SEG}, field=v)",
    f"TopN(w, {SEG}, n=5)",
    f"Min({SEG}, field=v)",
    f"Max({SEG}, field=v)",
    f"TopN(w, {SEG}, ids=[1, 2, 3, 4])",
    f"GroupBy(Rows(field=g), filter={SEG})",
    f"TopN(w, Intersect({SEG}, Row(w=4)), n=3)",
]


def norm(x):
    if isinstance(x, list):
        return [norm(g) for g in x]
    if hasattr(x, "to_dict"):
        return x.to_dict()
    if isinstance(x, tuple):
        return tuple(x)
    return x


def test_executor_dashboard_concurrent(twins):
    """The dashboard as separate queries from threads at once, the HTTP
    arrival shape: the aggregates and the Count (the executor's Count lane
    goes through the batcher, as the reference's does) ride one fused
    program, and every response equals the JAX host executor's."""
    jh, th = twins
    eng = TorchEngine(th, device="cpu")
    eng.result_memo.maxsize = 0
    ex = Executor(th, engine=eng)
    jex = JExecutor(jh)
    want = [norm(jex.execute("i", q).results) for q in DASH_QUERIES]
    b, release = _held(eng)
    threads, out = _run([(k, lambda q=q: ex.execute("i", q).results)
                         for k, q in enumerate(DASH_QUERIES)])
    release(len(DASH_QUERIES))
    _join(threads)
    for k, q in enumerate(DASH_QUERIES):
        assert norm(out[k]) == want[k], q
    assert eng.fused_programs == 1 and eng.fused_program_queries == len(DASH_QUERIES)
    assert ex.host_fallbacks == 0
    eng.close()


def test_executor_aggregates_sequential(twins):
    """One query at a time: each aggregate takes the batcher's direct path,
    the answers equal the JAX fused executor's."""
    jh, th = twins
    ex = Executor(th, engine=TorchEngine(th, device="cpu"))
    jex = JExecutor(jh, mesh_engine=MeshEngine(jh, make_mesh(8)))
    for q in DASH_QUERIES + ["TopN(w, n=2)", "Max(field=v)"]:
        assert norm(ex.execute("i", q).results) == norm(jex.execute("i", q).results), q
    assert ex.engine.fused_programs == 0


# -- the engine's cache tallies against the reference's ------------------------

TALLY_QUERIES = [
    "Count(Intersect(Row(seg=0), Row(w=1)))",
    "Count(Intersect(Row(seg=0), Row(w=1)))",
    "Count(Row(w=1)) Count(Union(Row(w=2), Row(g=1))) Count(Union(Row(w=2), Row(g=1)))",
    "Sum(field=v)", "Sum(field=v)", "Min(field=v)", "Min(field=v)", "Max(field=v)",
    "Max(Row(w=2), field=v)", "Max(Row(w=2), field=v)",
    "TopN(w, n=3)", "TopN(w, n=3)",
    "GroupBy(Rows(field=g), Rows(field=w))", "GroupBy(Rows(field=g), Rows(field=w))",
]
# The tallies the reference's executor and engine keep the same way; the
# stack, mask and canonical caches count the port's own lookups (its
# lowering differs), and scalar and zeros are XLA operand caches the port
# does not have.
SHARED_TALLIES = ("result_memo", "batch_cse", "fused_plan", "memo_sum", "memo_min",
                  "memo_max", "memo_topn", "memo_groupby")


def test_cache_tallies_match_the_reference(twins):
    """One fixed sequence (repeated Counts, a multi-Count query with a
    duplicate, Sum/Min/Max repeated, a cache-only TopN and a GroupBy
    twice, one dashboard drain twice) through both executors and engines:
    ``cache_snapshot()["caches"]`` has the reference's names, and the
    memo, batch-CSE and fused-plan tallies equal the reference's."""
    from pilosa_tpu.util.stats import ENGINE_CACHES as J_CACHES
    from pilosa_tpu_torch.util.stats import ENGINE_CACHES as T_CACHES

    jh, th = twins
    jeng, teng = MeshEngine(jh, make_mesh(8)), TorchEngine(th, device="cpu")
    jex, tex = JExecutor(jh, mesh_engine=jeng), Executor(th, engine=teng)
    try:
        for text in TALLY_QUERIES:
            want = jex.execute("i", text).results
            got = tex.execute("i", text).results
            assert len(got) == len(want), text
        for _ in range(2):
            jeng.fused_many("i", _widgets(jp, 4))
            teng.fused_many("i", _widgets(tp, 4))
        got, want = teng.cache_snapshot()["caches"], jeng.cache_snapshot()["caches"]
        assert T_CACHES == J_CACHES and list(got) == list(want)
        assert {k: got[k] for k in SHARED_TALLIES} == {k: want[k] for k in SHARED_TALLIES}
        assert got["fused_plan"] == {"hits": 1, "misses": 1}
        assert got["batch_cse"]["hits"] >= 1 and got["memo_sum"] == {"hits": 1, "misses": 1}
        assert got["scalar"] == got["zeros"] == {"hits": 0, "misses": 0}
        assert got["stack"]["hits"] > 0 and got["canonical"]["hits"] > 0
    finally:
        teng.close()
