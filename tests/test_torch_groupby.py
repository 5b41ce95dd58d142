"""GroupBy and Rows in the port against the JAX package, on one seeded
index built in both packages from the same numpy data: the plain version
of K8 (``parallel/groupby.groupn_tree_plain``) against the XLA
``kernels.groupn_tree`` on the test mesh, ``TorchEngine.group_counts``
against ``MeshEngine.group_counts``, and the port's ``Executor`` with and
without its engine against the JAX executor with and without its
``MeshEngine``, result for result (``to_dict``).  Every answer is an
integer: exact agreement (tolerance 0).

Fields (3 shards): ``a`` 4 rows that differ between shards (row 3 missing
from shard 2, row 5 only in shard 0), ``b`` 2 rows, ``c`` 3 rows, ``sp``
sparse rows in a few occupancy blocks, ``e`` empty, ``big`` 33 rows,
``p``/``q`` 32 rows each (1024 combinations), ``r41``/``r25`` (1025), and
the BSI field ``v`` for range filters.  The JAX fused lane compiles one
XLA program per shape on the CPU, so it runs only at small combination
counts; at 1024 and 1025 the port is held against the JAX host lane."""

import numpy as np
import pytest
import torch

from pilosa_tpu import pql as jpql
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.parallel import kernels as jkernels
from pilosa_tpu.parallel.engine import _Lowering as JLowering
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.convert import stack_from_numpy
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor import Executor, FieldNotFoundError
from pilosa_tpu_torch.executor.executor import Error
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.parallel import groupby as groupby_mod
from pilosa_tpu_torch.parallel.engine import TorchEngine

N_SHARDS = 3
SW = bitops.SHARD_WIDTH
BLOCK = bitops.OCC_BLOCK_BITS

# name: ({shard: row ids}, bits per row and shard); None = every shard.
SET_FIELDS = {
    "a": ({0: (0, 1, 2, 3, 5), 1: (0, 1, 2, 3), 2: (0, 1, 2)}, 60000),
    "b": (None, 60000),
    "c": (None, 40000),
    "sp": (None, 16000),
    "big": (None, 120),
    "p": (None, 60),
    "q": (None, 60),
    "r41": (None, 40),
    "r25": (None, 40),
}
ROWS = {"b": (1, 2), "c": (0, 1, 2), "sp": (0, 1), "big": tuple(range(33)),
        "p": tuple(range(32)), "q": tuple(range(32)), "r41": tuple(range(41)),
        "r25": tuple(range(25))}


def seeded_data(seed=17):
    """{field: (rows, cols)} for the set fields, and the BSI field v's
    (cols, values)."""
    rng = np.random.default_rng(seed)
    data = {}
    for name, (per_shard, n) in SET_FIELDS.items():
        rows, cols = [], []
        for s in range(N_SHARDS):
            for r in (per_shard[s] if per_shard else ROWS[name]):
                if name == "sp":  # two occupancy blocks of the 64
                    pos = np.concatenate([b * BLOCK + rng.choice(BLOCK, n // 2, replace=False)
                                          for b in (3, 41)])
                elif name in ("p", "q", "r41", "r25", "big"):
                    # Within the first 2^16 columns, so that rows meet.
                    pos = rng.choice(1 << 16, n, replace=False)
                else:
                    pos = rng.choice(SW, n, replace=False)
                rows.append(np.full(pos.size, r))
                cols.append(s * SW + pos)
        data[name] = (np.concatenate(rows), np.concatenate(cols))
    cols = np.concatenate([s * SW + rng.choice(SW, 30000, replace=False)
                           for s in range(N_SHARDS)])
    data["v"] = (cols, rng.integers(0, 256, cols.size))
    return data


def fill(holder, data, FieldOptions):
    idx = holder.create_index("i")
    every = set()
    for name in SET_FIELDS:
        rows, cols = data[name]
        idx.create_field(name).import_bulk(rows.tolist(), cols.tolist())
        every.update(cols.tolist())
    idx.create_field("e")
    cols, vals = data["v"]
    idx.create_field("v", FieldOptions(type="int", min=0, max=255)).import_values(
        cols.tolist(), vals.tolist())
    every.update(cols.tolist())
    idx.add_column_existence(sorted(every))
    return holder


def build_twins(seed=17):
    data = seeded_data(seed)
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    return fill(jh, data, JFieldOptions), fill(th, data, TFieldOptions)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch ops, which are many and
    small: under several test workers on a few cores a thread pool per
    worker spends its time contending, not counting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    return build_twins()


@pytest.fixture(scope="module")
def jeng(twins):
    return MeshEngine(twins[0], make_mesh(8))


@pytest.fixture(scope="module")
def execs(twins, jeng):
    jh, th = twins
    return {
        "jfused": JExecutor(jh, mesh_engine=jeng),
        "jhost": JExecutor(jh),
        "port": Executor(th, engine=TorchEngine(th, device="cpu")),
        "port_host": Executor(th),
    }


def norm(x):
    """A result in a form both packages share."""
    if isinstance(x, list):
        return [norm(g) for g in x]
    if hasattr(x, "to_dict"):
        return x.to_dict()
    return x


def answers(execs, q, shards=None, which=("jfused", "jhost", "port", "port_host")):
    out = {k: norm(execs[k].execute("i", q, shards=shards).results) for k in which}
    first = out[which[0]]
    for k, v in out.items():
        assert v == first, (q, k, v, which[0], first)
    return first


# -- the plain version of K8 against the XLA groupn_tree -----------------------


def _jax_groupn(jeng, fields, row_lists, filter_q, shards):
    """``pilosa_tpu.parallel.kernels.groupn_tree`` over the JAX engine's
    stacks, called as its engine calls it."""
    from jax.sharding import PartitionSpec as P

    from pilosa_tpu.parallel.mesh import put_global

    canonical = jeng.canonical_shards("i")
    stacks = [jeng.field_stack("i", f, "standard", canonical) for f in fields]
    statics, extra = [], []
    for st, rows in zip(stacks, row_lists):
        t = tuple(st.row_index[r] for r in rows)
        if jkernels.gather_free(t):
            statics.append(t)
        else:
            statics.append(None)
            extra.append(put_global(jeng.mesh, np.asarray(t, dtype=np.int32), P()))
    lw = JLowering(jeng, canonical)
    prog = jeng._lower_filter("i", None if filter_q is None else jpql.parse(filter_q).calls[0],
                              lw)
    mask = jeng._mask_words(shards, canonical)
    out = jkernels.groupn_tree(jeng.mesh, prog, (P(),) * len(extra) + tuple(lw.specs),
                               tuple(statics), mask, *[st.matrix for st in stacks], *extra,
                               *lw.operands)
    return np.asarray(out).reshape(-1)


@pytest.mark.parametrize("fields,subset,filter_q,shards", [
    (("a",), False, None, [0, 1, 2]),
    (("a", "b"), False, None, [0, 1, 2]),
    (("a", "b"), True, "Row(c=1)", [0, 2]),
    (("a", "b", "c"), False, "Row(c=1)", [0, 1, 2]),
    (("b", "c", "sp", "a"), True, None, [1, 2]),
    (("b", "a"), False, "Row(c=1)", [0, 1, 2]),
])
def test_plain_matches_jax_kernel(jeng, fields, subset, filter_q, shards):
    canonical = jeng.canonical_shards("i")
    row_lists = []
    for f in fields:
        rows = sorted(jeng.field_stack("i", f, "standard", canonical).row_index)
        row_lists.append(rows[1::2] if subset and len(rows) > 2 else rows)
    want = _jax_groupn(jeng, fields, row_lists, filter_q, shards)
    # The JAX stacks carried across (the port pads nothing).
    conv = {}
    for f in set(fields) | {"c"}:
        st = jeng.field_stack("i", f, "standard", canonical)
        conv[f] = stack_from_numpy(np.asarray(st.matrix), st.row_index, st.occ, st.shards,
                                   device="cpu")
    prog = None if filter_q is None else ("row", 0, conv["c"].row_index[1])
    mask = torch.tensor([1 if s in shards else 0 for s in canonical], dtype=torch.int32)
    idx_lists = [[conv[f].row_index[r] for r in rows] for f, rows in zip(fields, row_lists)]
    got = groupby_mod.groupn_tree_plain(prog, [conv["c"].matrix], mask,
                                        [conv[f].matrix for f in fields], idx_lists)
    assert got.dtype == torch.int64
    assert got.tolist() == want.tolist()
    assert int(got.sum()) > 0


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors ``groupn_tree`` runs the plain version (no launch): a
    row of -1 reads as zeros, a zero filter counts nothing, and the limits
    of K8 hold on both sides."""
    rng = np.random.default_rng(5)
    S = 2
    st = torch.from_numpy(rng.integers(0, 1 << 32, (3, S, 32768), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32))
    mask = torch.tensor([1, 0], dtype=torch.int32)
    launches = groupby_mod.groupn_tree_cuda.launches
    got = groupby_mod.groupn_tree(None, [], mask, [st, st], [[0, -1, 2], [1]])
    pc = lambda w: int(bitops.popcount_words(w).sum())  # noqa: E731
    assert got.tolist() == [pc(st[0, 0] & st[1, 0]), 0, pc(st[2, 0] & st[1, 0])]
    assert groupby_mod.groupn_tree(("zero",), [], mask, [st], [[0, 1]]).tolist() == [0, 0]
    assert groupby_mod.groupn_tree(None, [], mask, [st], [[]]).tolist() == []
    assert groupby_mod.groupn_tree_cuda.launches == launches
    with pytest.raises(ValueError, match="combinations"):
        groupby_mod.groupn_tree(None, [], mask, [st, st], [[0] * 33, [1] * 32])
    with pytest.raises(ValueError, match="fields"):
        groupby_mod.groupn_tree(None, [], mask, [st] * 9, [[0]] * 9)
    with pytest.raises(ValueError, match="outside stack"):
        groupby_mod.groupn_tree(None, [], mask, [st], [[3]])


@pytest.mark.parametrize("ks,form,order", [
    ((1,), "registers", [0]),
    ((4,), "registers", [0]),
    ((5,), "walk", [0]),
    ((33,), "walk", [0]),
    ((4, 2), "registers", [0, 1]),
    ((2, 4), "registers", [1, 0]),
    ((2, 3), "registers", [1, 0]),
    ((3, 3), "walk", [0, 1]),
    ((4, 2, 2), "registers", [0, 1, 2]),
    ((2, 2, 4), "registers", [2, 0, 1]),
    ((2, 1, 4, 2), "registers", [2, 0, 3, 1]),  # 16 combinations
    ((2, 2, 4, 2), "registers", [2, 0, 1, 3]),  # 32: the most in registers
    ((2, 2, 2, 2, 2), "walk", [0, 1, 2, 3, 4]),  # 32 but five fields
    ((3, 11), "walk", [1, 0]),  # 33
    ((32, 32), "walk", [0, 1]),  # 1024: 32 rows staged, the most
    ((2,) * 8, "walk", list(range(8))),
    ((4, 2, 16), "walk", [2, 0, 1]),  # 128: 6 rows staged
])
def test_groupn_plan_orders_levels_and_strides(ks, form, order):
    """K8's launch plan: the field with the most rows first (the walk
    then stages the fewest rows), the register form where the shape fits
    it in that order, and each level's stride in the row-major output.
    The plain version run on the fields in level order, each combination
    put back at its strides' place, must equal the plain version in the
    query's order: the placement either form of the kernel makes (exact,
    integer counts)."""
    got_form, got_order, strides = groupby_mod.groupn_plan(list(ks))
    assert (got_form, got_order) == (form, order)
    rng = np.random.default_rng(len(ks) * 10 + sum(ks))
    S = 2
    mats = [torch.from_numpy(rng.integers(0, 1 << 32, (k + 1, S, 32768), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)) for k in ks]
    lists = [list(range(k)) for k in ks]
    if ks[0] > 1:
        lists[0][0] = -1  # a row the stack lacks
    mask = torch.ones(S, dtype=torch.int32)
    want = groupby_mod.groupn_tree_plain(None, [], mask, mats, lists)
    level = groupby_mod.groupn_tree_plain(None, [], mask, [mats[i] for i in order],
                                          [lists[i] for i in order])
    placed = torch.zeros_like(want)
    for v, count in enumerate(level.tolist()):
        c, rest = 0, v
        for L in reversed(range(len(ks))):
            k = len(lists[order[L]])
            c += (rest % k) * strides[L]
            rest //= k
        placed[c] = count
    assert placed.tolist() == want.tolist()
    assert int(want.sum()) > 0


# -- the engines, call for call ----------------------------------------------


@pytest.mark.parametrize("fields,filter_q,shards", [
    (("a", "b"), None, [0, 1, 2]),
    (("a", "b"), "Row(c=1)", [0, 1, 2]),
    (("a", "c"), "Range(v > 100)", [0, 2]),
    (("b", "sp"), "Intersect(Row(c=0), Range(v < 50))", [1]),
    (("a", "b", "c"), "Not(Row(sp=0))", [0, 1, 2]),
])
def test_engines_agree_call_for_call(twins, jeng, fields, filter_q, shards):
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    canonical = eng.canonical_shards("i")
    row_lists = [sorted({r for s in canonical
                         for r in th.fragment("i", f, "standard", s).row_ids()})
                 for f in fields]
    want = jeng.group_counts("i", list(fields), row_lists,
                             None if filter_q is None else jpql.parse(filter_q).calls[0], shards)
    got = eng.group_counts("i", list(fields), row_lists,
                           None if filter_q is None else tpql.parse(filter_q).calls[0], shards)
    assert got.shape == tuple(len(r) for r in row_lists)
    assert got.tolist() == np.asarray(want).tolist()
    assert eng.group_dispatches == 1 and eng.group_host_fallbacks == 0


def test_engine_declines_past_the_combination_cap(twins):
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    assert eng.group_counts("i", ["r41", "r25"], [ROWS["r41"], ROWS["r25"]], None,
                            [0, 1, 2]) is None
    assert (eng.group_dispatches, eng.group_host_fallbacks) == (0, 1)


def test_a_row_the_stack_lacks_counts_zero(twins):
    """A listed row with no bits anywhere (absent from the stack) counts 0
    in every combination (the JAX engine maps it to row 0)."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    got = eng.group_counts("i", ["a", "b"], [[0, 99], [1, 2]], None, [0, 1, 2])
    full = eng.group_counts("i", ["a", "b"], [[0], [1, 2]], None, [0, 1, 2])
    assert got.tolist() == [full[0].tolist(), [0, 0]]


# -- the executors -------------------------------------------------------------

GROUPBY_QUERIES = [
    "GroupBy(Rows(field=a))",
    "GroupBy(Rows(field=a), Rows(field=b))",
    "GroupBy(Rows(field=a), Rows(field=b), Rows(field=c))",
    "GroupBy(Rows(field=b), Rows(field=c), Rows(field=sp), Rows(field=a))",
    "GroupBy(Rows(field=a), Rows(field=b), filter=Row(c=1))",
    "GroupBy(Rows(field=a), Rows(field=c), filter=Range(v > 100))",
    "GroupBy(Rows(field=a), Rows(field=b), limit=3)",
    "GroupBy(Rows(field=a), Rows(field=b), limit=3, offset=2)",
    "GroupBy(Rows(field=a), Rows(field=b), offset=20)",
    "GroupBy(Rows(field=a), Rows(field=b), filter=Row(c=2), limit=4)",
    "GroupBy(Rows(field=a), Rows(field=e))",
    "GroupBy(Rows(field=a, limit=2), Rows(field=b))",
    "GroupBy(Rows(field=a), Rows(field=b, previous=1))",
    "GroupBy(Rows(field=a, previous=1), Rows(field=b, previous=1), limit=3)",
    f"GroupBy(Rows(field=a), Rows(field=c, column={SW + 5}))",
    "GroupBy(Rows(field=a, limit=0), Rows(field=b))",
]


@pytest.mark.parametrize("q", GROUPBY_QUERIES)
@pytest.mark.parametrize("shards", [None, [0, 2]], ids=["all", "subset"])
def test_groupby_matches(execs, q, shards):
    answers(execs, q, shards)


def test_fused_lane_takes_plain_rows_children(execs):
    """Plain Rows(field=f) children dispatch once through the engine; a
    child with limit or previous takes the host iterator with no dispatch
    and no fallback counted."""
    eng = execs["port"].engine
    eng.result_memo.clear()
    d0, f0 = eng.group_dispatches, execs["port"].host_fallbacks
    answers(execs, "GroupBy(Rows(field=a), Rows(field=c), filter=Row(b=2))")
    assert eng.group_dispatches == d0 + 1
    answers(execs, "GroupBy(Rows(field=a, limit=2), Rows(field=c))")
    answers(execs, "GroupBy(Rows(field=a), Rows(field=c, previous=0))")
    assert eng.group_dispatches == d0 + 1
    assert execs["port"].host_fallbacks == f0 and eng.group_host_fallbacks == 0


@pytest.mark.parametrize("q,fused", [
    ("GroupBy(Rows(field=big))", True),
    ("GroupBy(Rows(field=big), Rows(field=b), limit=40)", True),
    ("GroupBy(Rows(field=p), Rows(field=q))", True),
    ("GroupBy(Rows(field=r41), Rows(field=r25))", False),
    ("GroupBy(Rows(field=r41), Rows(field=r25), limit=7, offset=3)", False),
])
def test_wide_groupbys_match_the_host_lane(execs, q, fused):
    """At 33, 66 and 1024 combinations the port's fused lane runs; at 1025
    it declines to the host iterator, counted.  Held against the JAX host
    lane (a 1024-combination XLA compile is slow on the CPU)."""
    eng = execs["port"].engine
    eng.result_memo.clear()
    d0, h0 = eng.group_dispatches, eng.group_host_fallbacks
    got = answers(execs, q, which=("jhost", "port", "port_host"))
    assert got
    assert eng.group_dispatches - d0 == int(fused)
    assert eng.group_host_fallbacks - h0 == int(not fused)


def test_groupby_errors(execs):
    for k in ("port", "port_host"):
        ex = execs[k]
        with pytest.raises(Error, match="child"):
            ex.execute("i", "GroupBy()")
        with pytest.raises(FieldNotFoundError):
            ex.execute("i", "GroupBy(Rows(field=missing))")
        with pytest.raises(Error, match="Rows"):
            ex.execute("i", "GroupBy(Row(a=0))")
        with pytest.raises(FieldNotFoundError):
            ex.execute("i", "GroupBy(Rows(field=a), filter=Row(nope=1))")


def test_groupby_memo_hit_then_a_write_misses():
    """A repeat GroupBy is a memo hit with no dispatch; after a write to a
    group field the repeat misses and sees the write: the repair layer
    serves it from the write's delta with no dispatch, and with the repair
    layer suspended it dispatches."""
    jh, th = build_twins()
    jex, tex = JExecutor(jh), Executor(th, engine=TorchEngine(th, device="cpu"))
    eng = tex.engine
    q = "GroupBy(Rows(field=a), Rows(field=b), filter=Row(c=1))"
    first = norm(tex.execute("i", q).results)
    hits = eng.result_memo.hits
    assert norm(tex.execute("i", q).results) == first == norm(jex.execute("i", q).results)
    assert eng.result_memo.hits == hits + 1 and eng.group_dispatches == 1
    # A column in a, b and c: the (a=0, b=1) count moves by one.
    col = SW + 77
    for w in (f"Set({col}, a=0)", f"Set({col}, b=1)", f"Set({col}, c=1)"):
        jex.execute("i", w)
        tex.execute("i", w)
    after = norm(tex.execute("i", q).results)
    assert eng.group_dispatches == 1 and eng.repairs.repaired["groupby"] == 1
    assert after == norm(jex.execute("i", q).results) != first
    with eng.repairs.suspended():
        eng.result_memo.clear()
        assert norm(tex.execute("i", q).results) == after
    assert eng.group_dispatches == 2
    # A new row of a group field widens the axis: the row lists follow.
    for w in (f"Set({col}, a=7)", f"Set({col + 1}, a=7)", f"Set({col + 1}, b=2)",
              f"Set({col + 1}, c=1)"):
        jex.execute("i", w)
        tex.execute("i", w)
    grown = norm(tex.execute("i", q).results)
    assert grown == norm(jex.execute("i", q).results)
    assert {"field": "a", "rowID": 7} in [g["group"][0] for g in grown[0]]


# -- Rows --------------------------------------------------------------------

ROWS_QUERIES = [
    "Rows(field=a)",
    "Rows(field=a, previous=1)",
    "Rows(field=a, limit=2)",
    "Rows(field=a, previous=0, limit=2)",
    "Rows(field=big, previous=30)",
    "Rows(field=a, limit=0)",
    "Rows(field=e)",
    "Rows(field=sp, previous=5)",
]


@pytest.mark.parametrize("q", ROWS_QUERIES)
@pytest.mark.parametrize("shards", [None, [2]], ids=["all", "shard2"])
def test_rows_match(execs, q, shards):
    answers(execs, q, shards)


def test_rows_column_matches(twins, execs):
    """Rows(column=) reads only the column's shard, whatever was asked."""
    _, th = twins
    frag = th.fragment("i", "a", "standard", 0)
    col = int(frag.row_positions(5)[0])  # row 5 lives in shard 0 only
    for q in (f"Rows(field=a, column={col})", f"Rows(field=a, column={col}, limit=1)",
              f"Rows(field=a, column={col}, previous=2)", f"Rows(field=a, column={2 * SW + 9})",
              f"Rows(field=c, column={SW + 3})"):
        answers(execs, q)
        answers(execs, q, shards=[1])
    assert 5 in answers(execs, f"Rows(field=a, column={col})")[0]


def test_rows_errors(execs):
    for k in ("port", "port_host"):
        with pytest.raises(Error, match="field"):
            execs[k].execute("i", "Rows()")
        with pytest.raises(FieldNotFoundError):
            execs[k].execute("i", "Rows(field=missing)")


# -- the reference's own fixtures ----------------------------------------------


def _spec_holder(holder):
    """test_executor_spec2.py's gb_env and test_executor_spec.py's
    groupby_env fixtures, in one index."""
    idx = holder.create_index("i")

    def imp(name, bits):
        idx.create_field(name).import_bulk([r for r, _ in bits], [c for _, c in bits])

    imp("general", [(10, 0), (10, 1), (10, SW + 1), (11, 2), (11, SW + 2), (12, 2),
                    (12, SW + 2)])
    imp("sub", [(100, 0), (100, 1), (110, 2), (110, SW + 2)])
    imp("ga", [(0, 1), (1, SW + 1)])
    imp("gb", [(0, SW + 1), (1, 1)])
    imp("ma", [(0, 0), (1, SW), (2, 0), (3, SW)])
    imp("mb", [(0, 0), (1, SW), (2, 0), (3, SW)])
    imp("na", [(0, 0), (0, SW), (1, 0), (1, SW)])
    imp("nb", [(0, 0), (0, SW), (1, 0), (1, SW)])
    pp = [(0, 0), (1, 0), (2, 0), (3, 0), (3, 91000), (3, SW), (3, SW * 2), (3, SW * 3)]
    for name in ("ppa", "ppb", "ppc"):
        imp(name, pp)
    for name in ("wa", "wb", "wc"):
        imp(name, [(0, 0), (0, 1), (0, 2), (1, 1), (2, 0), (2, 2), (3, 3)])
    for name in ("fa", "fb", "fc", "fd"):
        imp(name, [(0, 5), (1, 6)])
    return holder


@pytest.fixture(scope="module")
def spec_execs(jeng):
    jh, th = JHolder(), THolder(device="cpu")
    jh.open()
    th.open()
    _spec_holder(jh)
    _spec_holder(th)
    return {
        "jfused": JExecutor(jh, mesh_engine=MeshEngine(jh, make_mesh(8))),
        "jhost": JExecutor(jh),
        "port": Executor(th, engine=TorchEngine(th, device="cpu")),
        "port_host": Executor(th),
    }


SPEC_QUERIES = [
    "GroupBy(Rows(field=wa), Rows(field=wb), Rows(field=wc, previous=1), limit=3)",
    "GroupBy(Rows(field=wa, previous=3), Rows(field=wb, previous=3), "
    "Rows(field=wc, previous=3), limit=3)",
    "GroupBy(Rows(field=wa), Rows(field=wb, previous=2), Rows(field=wc, previous=2), limit=1)",
    "GroupBy(Rows(field=fa), Rows(field=fb), Rows(field=fc), Rows(field=fd))",
    "GroupBy(Rows(field=general), Rows(field=sub))",
    "GroupBy(Rows(field=general), Rows(field=sub), filter=Row(general=10))",
    "GroupBy(Rows(field=general, previous=10))",
    "GroupBy(Rows(field=general, previous=10), limit=1)",
    "GroupBy(Rows(field=ga), Rows(field=gb), limit=1)",
    "GroupBy(Rows(field=ma), Rows(field=mb), limit=5)",
    "GroupBy(Rows(field=ma), Rows(field=mb, limit=2), limit=5)",
    f"GroupBy(Rows(field=ma), Rows(field=mb, column={SW}), limit=5)",
    "GroupBy(Rows(field=na), Rows(field=nb))",
    "GroupBy(Rows(field=ppa), Rows(field=ppb), Rows(field=ppc), limit=3)",
]


@pytest.mark.parametrize("q", SPEC_QUERIES)
def test_reference_spec_queries(spec_execs, q):
    answers(spec_execs, q)


def test_reference_paging_with_previous(spec_execs):
    """The reference pages 4 x 4 x 4 combinations with limit=3 and
    previous= from the last group of each page (executor_test.go
    :3045-3070), on every executor."""
    pages = {}
    for k, ex in spec_execs.items():
        total = []
        q = "GroupBy(Rows(field=ppa), Rows(field=ppb), Rows(field=ppc), limit=3)"
        while len(total) < 64:
            res = ex.execute("i", q).results[0]
            assert res, "paging stalled"
            total.extend(res)
            last = total[-1].group
            q = (f"GroupBy(Rows(field=ppa, previous={last[0].row_id}), "
                 f"Rows(field=ppb, previous={last[1].row_id}), "
                 f"Rows(field=ppc, previous={last[2].row_id}), limit=3)")
        pages[k] = norm(total)
    assert all(v == pages["jhost"] for v in pages.values())
    assert pages["port"][-1]["count"] == 5
