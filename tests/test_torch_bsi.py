"""BSI in the port (``Range`` conditions, ``Sum``, ``Min``, ``Max``, and
``Field.import_values``) against the JAX package, on one seeded index built
in both packages from the same numpy data: the port's ``Executor`` with its
``TorchEngine`` (the range leaf in K1/K2, K6 ``sum_tree``, K7
``minmax_tree``, each in its plain version on the CPU) and without one
(the host lane), against the JAX executor through its ``MeshEngine`` and on
its host path, and the engines call for call.  Every answer is an integer:
exact agreement (tolerance 0).

Fields: ``v`` depth 8 (min 0), ``n`` a negative min (the base-value
offset), ``z`` depth 0 (min == max), ``sp`` with its high value planes
missing from every fragment, ``c`` whose columns sit in a few occupancy
blocks (the sparse path), ``deep`` at depth 41 (bits past 31), and the set
field ``g``.  The deep cases are few and share one module-scoped index:
the JAX CPU compile grows with the depth."""

import numpy as np
import pytest
import torch

from pilosa_tpu import pql as jpql
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.ops import bsi as jbsi
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor import Executor, ValCount
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.ops import bsi as tbsi
from pilosa_tpu_torch.parallel import bsi as bsi_mod
from pilosa_tpu_torch.parallel import kernels
from pilosa_tpu_torch.parallel.engine import TorchEngine

N_SHARDS = 3
SW = bitops.SHARD_WIDTH
BLOCK = bitops.OCC_BLOCK_BITS

# name: (min, max, columns per shard, largest base value written)
FIELDS = {
    "v": (0, 255, 3000, 255),
    "n": (-100, 100, 2000, 200),
    "z": (7, 7, 500, 0),
    "sp": (0, 255, 1500, 15),  # planes 4..7 are never set
    "c": (0, 255, 800, 255),  # columns in occupancy blocks 5 and 40 only
    "deep": (-(1 << 40), 1 << 40, 300, 1 << 41),
}


def seeded_data(seed=11):
    """{field: (cols, values)} plus the set field g's (rows, cols): the
    value lists repeat some columns (the last value wins), and hold every
    field's min and max."""
    rng = np.random.default_rng(seed)
    data = {}
    for name, (lo, hi, per, top) in FIELDS.items():
        cols = []
        for s in range(N_SHARDS):
            if name == "c":
                pos = np.concatenate([b * BLOCK + rng.choice(BLOCK, per // 2, replace=False)
                                      for b in (5, 40)])
            else:
                pos = rng.choice(SW, per, replace=False)
            cols.append(s * SW + pos)
        cols = np.concatenate(cols)
        vals = lo + rng.integers(0, top + 1, cols.size, dtype=np.int64)
        vals = np.minimum(vals, hi)
        vals[:2] = (lo, hi) if name != "sp" else (lo, lo + top)
        dup = rng.choice(cols.size, 50)
        cols = np.concatenate([cols, cols[dup]])
        vals = np.concatenate([vals, np.minimum(lo + rng.integers(0, top + 1, 50), hi)])
        data[name] = (cols, vals)
    g_rows, g_cols = [], []
    for r in (1, 2):
        for s in range(N_SHARDS):
            g_cols.append(s * SW + rng.choice(SW, 20000, replace=False))
            g_rows.append(np.full(20000, r))
    data["g"] = (np.concatenate(g_rows), np.concatenate(g_cols))
    return data


def fill(holder, data, FieldOptions):
    idx = holder.create_index("i")
    every = set()
    for name, (lo, hi, _, _) in FIELDS.items():
        cols, vals = data[name]
        idx.create_field(name, FieldOptions(type="int", min=lo, max=hi)).import_values(
            cols.tolist(), vals.tolist())
        every.update(cols.tolist())
    rows, cols = data["g"]
    idx.create_field("g").import_bulk(rows.tolist(), cols.tolist())
    every.update(cols.tolist())
    idx.add_column_existence(sorted(every))
    return holder


def build_twins(seed=11):
    data = seeded_data(seed)
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    return fill(jh, data, JFieldOptions), fill(th, data, TFieldOptions)


@pytest.fixture(scope="module")
def twins():
    return build_twins()


@pytest.fixture(scope="module")
def execs(twins):
    jh, th = twins
    return {
        "jfused": JExecutor(jh, mesh_engine=MeshEngine(jh, make_mesh(8))),
        "jhost": JExecutor(jh),
        "port": Executor(th, engine=TorchEngine(th, device="cpu")),
        "port_host": Executor(th),
    }


def norm(x):
    """A result in a form both packages share: ValCount as (value, count)."""
    if hasattr(x, "val") and hasattr(x, "count"):
        return ("vc", x.val, x.count)
    if hasattr(x, "columns"):
        return ("cols", x.columns().tolist())
    return x


def answers(execs, q, shards=None):
    out = {k: [norm(r) for r in ex.execute("i", q, shards=shards).results]
           for k, ex in execs.items()}
    assert out["jfused"] == out["jhost"], q
    return out


RANGE_QUERIES = [
    # every op on the depth-8 field, BETWEEN, != null
    "Range(v > 100)", "Range(v >= 100)", "Range(v < 37)", "Range(v <= 37)",
    "Range(v == 7)", "Range(v != 7)", "Range(10 <= v <= 200)", "Range(v >< [0, 1])",
    "Range(v != null)", "Range(v == 0)", "Range(v == 255)", "Range(v < 1)", "Range(v > 254)",
    # out of range, and bounds past min/max (the not-null row)
    "Range(v > 255)", "Range(v < 0)", "Range(v >= 0)", "Range(v <= 255)", "Range(v > -5)",
    "Range(v >< [-10, 300])", "Range(v >< [300, 400])", "Range(v == 300)", "Range(v != 300)",
    # a negative min
    "Range(n > -50)", "Range(n < 0)", "Range(n == -100)", "Range(-20 <= n <= 20)",
    "Range(n >= 100)", "Range(n <= -100)", "Range(n != 0)",
    # depth 0
    "Range(z == 7)", "Range(z != 7)", "Range(z > 6)", "Range(z < 7)", "Range(z > 7)",
    "Range(z >< [7, 7])",
    # missing planes, and the sparse path
    "Range(sp > 5)", "Range(sp < 200)", "Range(sp == 3)", "Range(2 <= sp <= 9)",
    "Range(c > 100)", "Range(c < 50)",
    # depth 41: bits past 31
    "Range(deep > 34359738368)", "Range(-549755813888 <= deep <= 8589934592)",
    # trees: rows and range leaves, two range leaves, Not
    "Intersect(Row(g=1), Range(v > 100))",
    "Union(Range(v < 10), Range(n > 50))",
    "Difference(Range(v != null), Range(v == 0))",
    "Xor(Range(v >= 128), Row(g=2))",
    "Not(Range(v > 100))",
]


@pytest.mark.parametrize("shards", [None, [0, 2]], ids=["all", "subset"])
@pytest.mark.parametrize("q", RANGE_QUERIES)
def test_range_counts_match(execs, q, shards):
    port = execs["port"]
    before = port.host_fallbacks
    out = answers(execs, f"Count({q})", shards)
    assert out["port"] == out["jfused"], q
    assert out["port_host"] == out["jfused"], q
    assert port.host_fallbacks == before, "a fused Count fell back to the host lane"


def test_range_leaf_takes_the_sparse_path(twins):
    """A range leaf's occupancy is its not-null plane's: c's values sit in
    two of the 64 blocks, so Count(Range(c > 100)) reads only those."""
    jh, th = twins
    eng = TorchEngine(th, device="cpu")
    shards = list(range(N_SHARDS))
    for q in ("Range(c > 100)", "Intersect(Range(c < 50), Row(g=1))"):
        got = eng.count("i", tpql.parse(q).calls[0], shards)
        assert eng.last_path == "sparse", q
        assert got == MeshEngine(jh, make_mesh(8)).count("i", jpql.parse(q).calls[0], shards)
    eng.count("i", tpql.parse("Range(v > 100)").calls[0], shards)
    assert eng.last_path == "dense"


AGG_QUERIES = [f"{agg}({flt}field={f})" for f in FIELDS
               for agg in ("Sum", "Min", "Max")
               for flt in ("", "Row(g=1), ", "Range(v > 100), ")
               if not (f == "deep" and flt)] + [
    "Sum(Range(n < 0), field=v)", "Min(Intersect(Row(g=2), Range(v < 30)), field=n)",
    "Max(Range(v > 1000), field=v)", "Sum(Row(g=99), field=v)", "Sum(field=g)",
    "Min(field=nope)",
]


@pytest.mark.parametrize("shards", [None, [1]], ids=["all", "one"])
@pytest.mark.parametrize("q", AGG_QUERIES)
def test_sum_min_max_match(execs, q, shards):
    port = execs["port"]
    before = port.host_fallbacks
    out = answers(execs, q, shards)
    assert out["port"] == out["jfused"], q
    assert out["port_host"] == out["jfused"], q
    assert port.host_fallbacks == before


@pytest.mark.parametrize("field", ["v", "n", "z", "sp", "deep"])
def test_engines_agree_call_for_call(twins, field):
    """TorchEngine.sum/min_max against MeshEngine.sum/min_max, unfiltered
    and filtered, on all shards and on one."""
    jh, th = twins
    jeng, teng = MeshEngine(jh, make_mesh(8)), TorchEngine(th, device="cpu")
    filters = [None] if field == "deep" else [None, "Row(g=1)"]
    for flt in filters:
        jf = None if flt is None else jpql.parse(flt).calls[0]
        tf = None if flt is None else tpql.parse(flt).calls[0]
        for shards in ([0, 1, 2], [2]):
            assert teng.sum("i", field, tf, shards) == jeng.sum("i", field, jf, shards)
            for is_min in (True, False):
                assert (teng.min_max("i", field, tf, shards, is_min)
                        == jeng.min_max("i", field, jf, shards, is_min))


def test_tree_past_the_limits_takes_the_host_lane(execs):
    """Five range leaves are one more than a tree takes: the engine
    declines (UnsupportedLowering) and the host lane answers."""
    q = ("Count(Union(Range(v > 10), Range(v < 3), Range(n > 0), Range(sp == 2), "
         "Range(c > 9)))")
    port = execs["port"]
    before = port.host_fallbacks
    out = answers(execs, q)
    assert out["port"] == out["jfused"]
    assert port.host_fallbacks == before + 1
    four = "Count(Union(Range(v > 10), Range(v < 3), Range(n > 0), Range(sp == 2)))"
    out = answers(execs, four)
    assert out["port"] == out["jfused"] and port.host_fallbacks == before + 1


def test_batch_declines_count_every_count_of_the_batch(execs):
    """A batch of Counts with one tree past the kernels' limits goes to the
    host lane whole: batch_declines rises by every Count of that batch, and
    the answers are the reference's."""
    port = execs["port"]
    eng = port.engine
    five = "Union(Range(v > 10), Range(v < 3), Range(n > 0), Range(sp == 2), Range(c > 9))"
    q = f"Count(Intersect(Row(g=1), Row(g=2))) Count({five}) Count(Range(v > 100))"
    d0, b0 = eng.batch_declines, eng.batch_dispatches
    with_memo = eng.result_memo.maxsize
    eng.result_memo.maxsize = 0
    try:
        out = answers(execs, q)
        assert out["port"] == out["jfused"]
        assert eng.batch_declines == d0 + 3 and eng.batch_dispatches == b0
    finally:
        eng.result_memo.maxsize = with_memo


def test_count_batch_takes_range_trees_in_k5(execs, twins):
    """K5 takes range leaves: a run of consecutive Counts, three of them
    with range leaves (two over one field, one over two fields' planes),
    is one batch with no decline, and the answers are the reference's,
    also through execute_async (the batcher)."""
    port = execs["port"]
    eng = port.engine
    q = ("Count(Range(v > 100)) Count(Intersect(Row(g=1), Row(g=2))) Count(Range(n < 0)) "
         "Count(Union(Row(g=1), Range(v == 5))) Count(Difference(Row(g=2), Row(g=1))) "
         "Count(Intersect(Range(v >< [10, 200]), Range(sp < 9)))")
    d0, b0, k0 = eng.batch_declines, eng.batch_dispatches, eng.dense_dispatches
    with_memo = eng.result_memo.maxsize
    eng.result_memo.maxsize = 0
    try:
        out = answers(execs, q)
        assert out["port"] == out["jfused"]
        assert eng.batch_declines == d0
        assert eng.batch_dispatches == b0 + 1 and eng.dense_dispatches == k0
        fut = port.execute_async("i", q)
        assert [norm(r) for r in fut.result(60).results] == out["jfused"]
        assert port.async_fallbacks == 0
    finally:
        eng.result_memo.maxsize = with_memo


@pytest.mark.parametrize("q", ["Range(v > 200)", "Range(n >< [-3, 3])", "Range(z == 7)",
                               "Range(deep < -549755813888)", "Intersect(Row(g=1), Range(sp < 4))"])
def test_row_results_match_host(execs, q):
    """A Row-valued Range at top level runs the host lane's torch ops per
    fragment (ops/bsi.py) in the port."""
    out = answers(execs, q)
    assert out["port"] == out["jhost"] and out["port_host"] == out["jhost"]


@pytest.mark.parametrize("q", ["TopN(g, Range(v > 100), n=2)",
                               "TopN(g, Intersect(Row(g=2), Range(n < 0)), n=1)"])
def test_topn_with_a_range_src_matches(execs, q):
    """A TopN src tree with a range leaf: K3 evaluates the leaf (its plain
    version here) in the one fused launch."""
    out = {k: [[tuple(p) for p in r] for r in ex.execute("i", q).results]
           for k, ex in execs.items()}
    assert out["port"] == out["jfused"] == out["jhost"] == out["port_host"]


def test_range_memo_keys_on_the_bsi_view(twins):
    """A write to v stales a memoized Count(Range(v ...)): the memo key
    carries the bsig_v view's version."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    c = tpql.parse("Range(v > 100)").calls[0]
    shards = list(range(N_SHARDS))
    key, hit = eng.memo_probe("i", c, shards)
    assert key is not None and hit is None
    assert "v" in eng._collect_fields(c)


# -- the plain BSI ops against the JAX package's -----------------------------


def _planes(rng, depth, w=4096):
    p = rng.integers(0, 1 << 32, (depth + 1, w), dtype=np.uint64).astype(np.uint32)
    p[:, :8] = 0xFFFFFFFF
    p[:, 8:16] = 0x80000000
    p[:, 16:24] = 0
    return p


@pytest.mark.parametrize("depth", [1, 8, 33])
def test_bsi_ops_match_jax(depth):
    import jax.numpy as jnp

    rng = np.random.default_rng(depth)
    p = _planes(rng, depth)
    tp = torch.from_numpy(p.view(np.int32))
    jp = jnp.asarray(p)
    flt = rng.integers(0, 1 << 32, p.shape[1], dtype=np.uint64).astype(np.uint32)
    tf, jf = torch.from_numpy(flt.view(np.int32)), jnp.asarray(flt)

    def same(t, j):
        np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j))

    preds = [0, (1 << depth) - 1, int(rng.integers(0, 1 << depth))]
    for v in preds:
        bits = jbsi.to_bits(v, depth)
        assert tbsi.to_bits(v, depth).tolist() == bits.tolist()
        jb = jnp.asarray(bits)
        same(tbsi.range_eq(tp, bits), jbsi.range_eq(jp, jb))
        same(tbsi.range_neq(tp, bits), jbsi.range_neq(jp, jb))
        for eq in (False, True):
            same(tbsi.range_lt(tp, bits, eq), jbsi.range_lt(jp, jb, eq))
            same(tbsi.range_gt(tp, bits, eq), jbsi.range_gt(jp, jb, eq))
        hi = jbsi.to_bits(preds[(preds.index(v) + 1) % 3], depth)
        same(tbsi.range_between(tp, bits, hi), jbsi.range_between(jp, jb, jnp.asarray(hi)))
    counts, n = tbsi.sum_counts(tp, tf)
    jc, jn = jbsi.sum_counts(jp, jf)
    assert counts.tolist() == np.asarray(jc).tolist() and int(n) == int(jn)
    for is_min, jfn in ((True, jbsi.min_valcount), (False, jbsi.max_valcount)):
        val, cnt = tbsi.minmax_valcount_nd(tp, tf, is_min)
        hi_, lo_, jcnt = jfn(jp, jf)
        assert int(cnt) == int(jcnt) and int(val) == (int(hi_) << 31) | int(lo_)


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors the K6/K7 and range-leaf wrappers run their plain
    versions (no kernel launch), and agree with ops/bsi.py."""
    rng = np.random.default_rng(3)
    S, depth = 2, 5
    st = torch.from_numpy(rng.integers(0, 1 << 32, (depth + 2, S, 32768), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32))
    planes = tuple(range(depth + 1))
    mask = torch.tensor([1, 0], dtype=torch.int32)
    launches = (bsi_mod.sum_tree_cuda.launches, bsi_mod.minmax_tree_cuda.launches,
                kernels.range_leaf.launches)
    out = bsi_mod.sum_tree(None, [], mask, st, planes)
    counts, n = tbsi.sum_counts(st[:depth + 1, 0], torch.full((32768,), -1, dtype=torch.int32))
    assert out.tolist() == counts.tolist() + [int(n)]
    vals, cnts = bsi_mod.minmax_tree(("row", 0, depth + 1), [st], mask, st, planes, True)
    v0, c0 = tbsi.min_valcount(st[:depth + 1, 0], st[depth + 1, 0])
    assert (int(vals[0]), int(cnts[0]), int(vals[1]), int(cnts[1])) == (int(v0), int(c0), 0, 0)
    leaf = ("range", "gt", 0, planes, 9, 0)
    got = kernels.count_tree(leaf, [st], mask)
    want = bitops.popcount(tbsi.range_gt(st[:depth + 1, 0], tbsi.to_bits(9, depth), False))
    assert int(got) == int(want)
    assert launches == (bsi_mod.sum_tree_cuda.launches, bsi_mod.minmax_tree_cuda.launches,
                        kernels.range_leaf.launches)
    with pytest.raises(ValueError, match="range leaves"):
        kernels.check_prog(kernels.compile_prog(("or",) + (leaf,) * 2 + tuple(
            ("range", "lt", 0, planes, k, 0) for k in range(4))))
    # K5 takes the range leaf: its planes are leaf-table rows.
    batch = kernels.compile_batch([leaf, ("and", leaf, ("row", 0, depth + 1))], [0, 0])
    assert batch.ranges.shape[0] == 1 and len(batch.leaves) == depth + 2
    assert kernels.count_batch_tree([leaf], [st], np.array([[1, 0]], bool), [0],
                                    "cpu").tolist() == [int(want)]


def test_decoders_match_the_reference():
    from pilosa_tpu.parallel import fusion

    counts = np.array([5, 0, 7, 1 << 30, 2], dtype=np.int64)
    assert bsi_mod.decode_sum(counts, 4, -3) == fusion.decode_sum((counts[:4], counts[4]), 4, -3)
    vals = np.array([9, 4, 4, 0, (1 << 40) + 3], dtype=np.int64)
    cnts = np.array([1, 2, 5, 0, 1], dtype=np.int64)
    his = (vals >> 31).astype(np.uint32)
    los = (vals & ((1 << 31) - 1)).astype(np.uint32)
    for is_min in (True, False):
        assert (bsi_mod.decode_min_max((vals, cnts), range(5), 10, is_min)
                == fusion.decode_min_max((his, los, cnts), range(5), 10, is_min))
    assert bsi_mod.decode_min_max((vals, np.zeros(5)), range(5), 10, True) == (0, 0)


# -- writes: import_values and Set(col, v=N) --------------------------------


@pytest.fixture
def small_twins():
    return build_twins(seed=5)


def _requery(execs, queries):
    for q in queries:
        out = answers(execs, q)
        assert out["port"] == out["jfused"] == out["port_host"], q


WRITE_QUERIES = ["Sum(field=v)", "Min(field=v)", "Max(Row(g=1), field=v)",
                 "Count(Range(v > 120))", "Count(Range(v != null))", "Sum(field=n)"]


@pytest.mark.parametrize("mode", ["overwrite", "fresh", "clear", "last_write_wins", "new_shard"])
def test_import_values_then_requery(small_twins, mode):
    """import_values in both packages, then every answer again: the port's
    resident bsig stack syncs in place (no rebuild) and the memo misses on
    the new version token."""
    jh, th = small_twins
    execs = {"jfused": JExecutor(jh, mesh_engine=MeshEngine(jh, make_mesh(8))),
             "jhost": JExecutor(jh), "port": Executor(th, engine=TorchEngine(th, device="cpu")),
             "port_host": Executor(th)}
    eng = execs["port"].engine
    _requery(execs, WRITE_QUERIES)
    rebuilds, updates = eng.stack_rebuilds, eng.stack_updates
    key = eng.memo_probe("i", tpql.parse("Range(v > 120)").calls[0], [0, 1, 2])[0]
    rng = np.random.default_rng(["overwrite", "fresh", "clear", "last_write_wins",
                                 "new_shard"].index(mode))
    old_cols = seeded_data(5)["v"][0]
    kw = {}
    if mode == "fresh":
        # Columns with no value yet (the set-only write).
        cols = np.setdiff1d(rng.choice(N_SHARDS * SW, 600), old_cols)
        kw["fresh"] = True
    elif mode == "new_shard":
        cols = N_SHARDS * SW + rng.choice(SW, 300, replace=False)
    else:
        cols = rng.choice(old_cols, 400)
    vals = rng.integers(0, 256, cols.size)
    if mode == "clear":
        kw["clear"] = True
    if mode == "last_write_wins":
        cols = np.concatenate([cols, cols[:100]])
        vals = np.concatenate([vals, 255 - vals[:100]])
    for h in (jh, th):
        h.index("i").field("v").import_values(cols.tolist(), vals.tolist(), **kw)
    _requery(execs, WRITE_QUERIES)
    new_key = eng.memo_probe("i", tpql.parse("Range(v > 120)").calls[0], [0, 1, 2])[0]
    assert new_key != key
    if mode == "new_shard":
        assert eng.stack_rebuilds > rebuilds  # a new shard changes the stack's shape
        _requery(execs, ["Sum(field=v)", "Count(Range(v < 9))"])
    else:
        assert eng.stack_rebuilds == rebuilds
        assert eng.stack_updates > updates


def test_import_values_rejects_out_of_range_before_writing(small_twins):
    _, th = small_twins
    f = th.index("i").field("v")
    v0 = f.view("bsig_v").version
    with pytest.raises(ValueError, match="out of range"):
        f.import_values([1, 2, 3], [1, 2, 256])
    assert f.view("bsig_v").version == v0


def test_set_value_syncs_the_stack_and_stales_the_memo(small_twins):
    jh, th = small_twins
    execs = {"jfused": JExecutor(jh, mesh_engine=MeshEngine(jh, make_mesh(8))),
             "jhost": JExecutor(jh), "port": Executor(th, engine=TorchEngine(th, device="cpu")),
             "port_host": Executor(th)}
    eng = execs["port"].engine
    _requery(execs, WRITE_QUERIES)
    rebuilds, updates = eng.stack_rebuilds, eng.stack_updates
    col = int(seeded_data(5)["v"][0][7])
    for ex in ("jhost", "port"):
        execs[ex].execute("i", f"Set({col}, v=201)")
    _requery(execs, WRITE_QUERIES)
    assert eng.stack_rebuilds == rebuilds and eng.stack_updates == updates + 1
    got = execs["port"].execute("i", "Max(field=v)").results[0]
    assert isinstance(got, ValCount) and got.val == 255


# -- state carried across ---------------------------------------------------


def test_open_holder_answers_bsi_like_jax(tmp_path):
    """A JAX Holder's data directory (the bsig_v views, with Set(col, v=N)
    writes in the op-log after the snapshot) opens in the port and gives
    the same Sum/Min/Max/Range answers."""
    from pilosa_tpu_torch.convert import open_holder

    path = str(tmp_path / "data")
    jh = JHolder(path)
    jh.open()
    fill(jh, seeded_data(9), JFieldOptions)
    jex = JExecutor(jh)
    for q in (f"Set({SW + 5}, v=77)", f"Set(3, n=-99)", f"Set({2 * SW + 1}, v=0)"):
        jex.execute("i", q)
    queries = ["Sum(field=v)", "Min(field=n)", "Max(Row(g=1), field=v)", "Sum(field=z)",
               "Count(Range(v == 77))", "Count(Range(-50 <= n <= 50))", "Count(Range(sp < 4))"]
    want = [norm(jex.execute("i", q).results[0]) for q in queries]
    jh.close()
    th = open_holder(path, device="cpu")
    for port in (Executor(th, engine=TorchEngine(th, device="cpu")), Executor(th)):
        assert [norm(port.execute("i", q).results[0]) for q in queries] == want
    th.close()
