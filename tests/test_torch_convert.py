"""Carrying state over from the JAX package (pilosa_tpu_torch.convert):
a JAX engine's field stack becomes the port's stack with the same words
and occupancy and the same counts, and a data directory written by
pilosa_tpu's Holder opens in the port and answers the same Counts.
Integer results: exact agreement (tolerance 0)."""

import numpy as np
import pytest
import torch

from pilosa_tpu import pql as jpql
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu_torch.convert import open_holder, stack_from_numpy
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.parallel import kernels, sparse
from pilosa_tpu_torch.parallel.engine import TorchEngine
from test_torch_engine import N_SHARDS, SW, build_twins, fill, seeded_data


@pytest.fixture(scope="module")
def jax_engine():
    jh, th = build_twins()
    return jh, th, MeshEngine(jh, make_mesh(8))


@pytest.mark.parametrize("field", ["d", "c"])
def test_stack_from_numpy_matches_port_build(jax_engine, field):
    _, th, jeng = jax_engine
    jst = jeng.field_stack("i", field, "standard")
    assert np.asarray(jst.matrix).shape[1] == 8  # padded to the JAX mesh
    st = stack_from_numpy(np.asarray(jst.matrix), jst.row_index, jst.occ,
                          jst.shards, device="cpu")
    assert st.matrix.shape[1] == N_SHARDS  # the port pads nothing
    own = TorchEngine(th, device="cpu").field_stack("i", field, "standard")
    assert torch.equal(st.matrix, own.matrix)
    np.testing.assert_array_equal(st.occ, own.occ)
    assert st.row_index == own.row_index


@pytest.mark.parametrize("field", ["d", "c"])
def test_converted_stack_counts_like_mesh_engine(jax_engine, field):
    _, _, jeng = jax_engine
    jst = jeng.field_stack("i", field, "standard")
    st = stack_from_numpy(np.asarray(jst.matrix), jst.row_index, None,
                          jst.shards, device="cpu")
    np.testing.assert_array_equal(st.occ, np.asarray(jst.occ)[:, :N_SHARDS])
    shards = list(range(N_SHARDS))
    r1, r2 = st.row_index[1], st.row_index[2]
    for op, name in (("and", "Intersect"), ("or", "Union"), ("xor", "Xor")):
        want = jeng.count("i", jpql.parse(f"{name}(Row({field}=1), Row({field}=2))").calls[0], shards)
        prog = (op, ("row", 0, r1), ("row", 0, r2))
        dense = kernels.count_tree(prog, [st.matrix], torch.ones(N_SHARDS, dtype=torch.int32))
        all_blocks = torch.full((N_SHARDS,), -1, dtype=torch.int64)
        blocks = sparse.count_tree_blocks(prog, [st.matrix], all_blocks)
        assert int(dense) == int(blocks) == want


def test_stack_from_numpy_rejects_bad_input():
    with pytest.raises(ValueError, match="uint32"):
        stack_from_numpy(np.zeros((1, 1, 8), np.int64), {0: 0}, None, [0], device="cpu")
    with pytest.raises(ValueError, match="shard positions"):
        stack_from_numpy(np.zeros((1, 1, 512), np.uint32), {0: 0}, None, [0, 1], device="cpu")


def test_open_holder_reads_a_jax_data_directory(tmp_path):
    path = str(tmp_path / "data")
    jh = JHolder(path)
    jh.open()
    fill(jh, seeded_data())
    jex = JExecutor(jh)
    # Single-bit writes land in the op-log after the snapshot.
    for q in (f"Set({SW + 3}, c=1)", f"Set({SW + 3}, c=2)", "Clear(5, d=1)", f"Set({2 * SW}, d=9)"):
        jex.execute("i", q)
    queries = [
        "Count(Intersect(Row(c=1), Row(c=2)))",
        "Count(Union(Row(d=1), Row(d=9)))",
        "Count(Difference(Row(d=1), Row(d=2)))",
        "Count(Xor(Row(c=3), Row(c=4)))",
        "Count(Not(Row(c=1)))",
        "Count(Row(d=9))",
    ]
    want = [jex.execute("i", q).results[0] for q in queries]
    jh.close()

    th = open_holder(path, device="cpu")
    assert sorted(th.indexes) == ["i"]
    assert sorted(th.index("i").fields) == ["c", "d", "exists"]
    assert th.local_shards("i") == list(range(N_SHARDS))
    port = Executor(th, engine=TorchEngine(th, device="cpu"))
    assert [port.execute("i", q).results[0] for q in queries] == want
    frag = th.fragment("i", "d", "standard", 2)
    assert frag.row_ids() == [1, 2, 3, 4, 9] and frag.row_count(9) == 1
    th.close()


def test_open_holder_answers_topn_like_jax(tmp_path):
    """A data directory with a TopN field and its rank-cache .cache files,
    written by pilosa_tpu's Holder, opens in the port (the caches load
    through Fragment._load_cache_file) and answers the TopN query set
    exactly as the JAX executors do."""
    import glob
    import os

    from test_torch_topn import QUERIES as TOPN_QUERIES
    from test_torch_topn import fill as topn_fill
    from test_torch_topn import topn_data

    path = str(tmp_path / "data")
    jh = JHolder(path)
    jh.open()
    topn_fill(jh, topn_data())
    jex = JExecutor(jh)
    for q in (f"Set({SW + 7}, t=1)", "Clear(5, t=20)", f"Set({3 * SW + 1}, t=40)"):
        jex.execute("i", q)
    fused = JExecutor(jh, mesh_engine=MeshEngine(jh, make_mesh(8)))
    want = [[tuple(p) for p in fused.execute("i", q).results[0]] for q in TOPN_QUERIES]
    assert want == [[tuple(p) for p in jex.execute("i", q).results[0]] for q in TOPN_QUERIES]
    cache_top = jh.fragment("i", "t", "standard", 3).cache.top()
    jh.close()
    assert glob.glob(os.path.join(path, "i", "t", "views", "standard", "fragments", "*.cache"))

    th = open_holder(path, device="cpu")
    assert th.fragment("i", "t", "standard", 3).cache.top() == cache_top
    for port in (Executor(th, engine=TorchEngine(th, device="cpu")), Executor(th)):
        got = [[tuple(p) for p in port.execute("i", q).results[0]] for q in TOPN_QUERIES]
        assert got == want
    th.close()


def test_open_holder_and_translate_store_carry_attrs_and_keys(tmp_path):
    """A data directory written through pilosa_tpu's API, with a keyed
    index and field, row and column attributes and its ``.keys`` translate
    log, opens in the port (``open_holder`` reads the ``.data`` attribute
    stores, ``open_translate_store`` the log) with the same attributes and
    keys, answers keyed queries as the reference did, and assigns the next
    keys the reference's ids."""
    import os

    from pilosa_tpu import api as japi
    from pilosa_tpu.core.translate import TranslateFile as JTranslateFile
    from pilosa_tpu_torch import api as tapi
    from pilosa_tpu_torch.convert import open_translate_store

    path = str(tmp_path / "data")
    keys_path = os.path.join(path, ".keys")
    jh = JHolder(path)
    jh.open()
    jstore = JTranslateFile(keys_path)
    jstore.open()
    j = japi.API(holder=jh, translate_store=jstore)
    j.create_index("k", keys=True)
    j.create_field("k", "f", {"keys": True})
    j.create_field("k", "n")
    rng = np.random.default_rng(31)
    users = [f"u{i}" for i in range(500)]
    pick = rng.integers(0, 500, 2000)
    j.import_bits(japi.ImportRequest("k", "f", column_keys=[users[i] for i in pick],
                                     row_keys=[f"s{i % 5}" for i in rng.integers(0, 5, 2000)]))
    j.import_bits(japi.ImportRequest("k", "n", column_keys=users[:300],
                                     row_ids=rng.integers(0, 3, 300).tolist()))
    j.query(japi.QueryRequest(
        "k", 'SetRowAttrs(f, "s1", label="one", w=1) SetRowAttrs(n, 2, ok=true) '
             'SetColumnAttrs("u7", tier=3) SetColumnAttrs("u8", tier=4)'))
    queries = ['Row(f="s1")', 'Count(Intersect(Row(f="s1"), Row(f="s2")))', "TopN(f, n=3)",
               'TopN(f, Row(n=1), n=2)', "Rows(field=f)", "Row(n=2)",
               "GroupBy(Rows(field=f), Rows(field=n))"]
    want = [j.query(japi.QueryRequest("k", q, column_attrs=True)) for q in queries]
    row_attrs = jh.index("k").field("f").row_attr_store.blocks()
    col_attrs = jh.index("k").column_attr_store.blocks()
    jh.close()
    jstore.close()

    th = open_holder(path, device="cpu")
    tstore = open_translate_store(keys_path)
    assert th.index("k").keys and th.index("k").field("f").options.keys
    assert th.index("k").field("f").row_attr_store.blocks() == row_attrs
    assert th.index("k").column_attr_store.blocks() == col_attrs
    t = tapi.API(holder=th, translate_store=tstore)
    for q, w in zip(queries, want):
        got = t.query(tapi.QueryRequest("k", q, column_attrs=True))
        assert [c.to_dict() for c in got.column_attr_sets] == \
            [c.to_dict() for c in w.column_attr_sets], q
        g, w = got.results[0], w.results[0]
        if hasattr(w, "columns"):
            assert (g.keys, g.attrs) == (w.keys, w.attrs), q
            np.testing.assert_array_equal(g.columns(), w.columns())
        elif isinstance(w, list) and w and hasattr(w[0], "group"):
            assert [x.to_dict() for x in g] == [x.to_dict() for x in w], q
        elif hasattr(w, "rows"):
            assert (g.rows, g.keys) == (w.rows, w.keys), q
        else:
            assert g == w, q
    jnext = JTranslateFile(keys_path)
    jnext.open()
    assert t.translate_keys("k", "", ["new1", "u3"]) == \
        jnext.translate_columns_to_uint64("k", ["new1", "u3"])
    assert t.translate_keys("k", "f", ["s9"]) == jnext.translate_rows_to_uint64("k", "f", ["s9"])
    t.close()
    tstore.close()
