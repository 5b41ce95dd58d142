"""The port's API (pilosa_tpu_torch.api) against the JAX package's
(pilosa_tpu.api.API) on the same inputs.

- ``query`` and ``query_async`` answer as the reference's ``query``, with
  keys, Options(shards=...), columnAttrs and the row attribute flags;
- ``import_bits`` (ids, row and column keys, timestamps, clear),
  ``import_values`` (ids and keys), ``import_roaring`` (union and clear,
  with the bits changed) and ``export_csv`` leave the same data;
- the schema and the index/field/view life cycle, ``max_shards``,
  ``available_shards_by_index``, ``info`` and ``translate_keys``;
- ``Field.row_time`` gives the reference's row for each quantum;
- ``import_roaring`` and a keyed ``import_bits`` sync a resident stack in
  place (``stack_updates`` up by one, ``stack_rebuilds`` unchanged);
- ``API()`` builds on the card by default and raises without one; what the
  API leaves out raises naming the ROADMAP.md item that ports it.

Ids, keys, counts and CSV text are discrete: exact agreement (tolerance 0)."""

import datetime as dt
import io

import numpy as np
import pytest

from pilosa_tpu import api as japi
from pilosa_tpu.roaring import codec as jcodec
from pilosa_tpu_torch import api as tapi
from pilosa_tpu_torch.core.translate import TranslateFile

SW = 1 << 20


def both():
    return japi.API(), tapi.API(device="cpu")


def rows_equal(got, want):
    assert got.keys == want.keys
    assert got.attrs == want.attrs
    np.testing.assert_array_equal(got.columns(), want.columns())


def same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if hasattr(w, "columns"):
            rows_equal(g, w)
        elif isinstance(w, list) and w and hasattr(w[0], "group"):
            assert [x.to_dict() for x in g] == [x.to_dict() for x in w]
        elif hasattr(w, "rows") and hasattr(w, "keys"):
            assert (g.rows, g.keys) == (w.rows, w.keys)
        elif hasattr(w, "val"):
            assert (g.val, g.count) == (w.val, w.count)
        elif isinstance(w, list):
            assert [tuple(p) for p in g] == [tuple(p) for p in w]
        else:
            assert g == w


def query(api, index, q, **kw):
    mod = tapi if isinstance(api, tapi.API) else japi
    return api.query(mod.QueryRequest(index, q, **kw))


def ask(apis, index, q, **kw):
    j, t = apis
    want, got = query(j, index, q, **kw), query(t, index, q, **kw)
    same_results(got.results, want.results)
    cs = [[c.to_dict() for c in r.column_attr_sets or []] for r in (got, want)]
    assert cs[0] == cs[1]
    return got


def seeded_bits(seed, n_rows, n, shards=(0, 1, 2)):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n)
    cols = rng.choice(np.array(shards), n) * SW + rng.integers(0, 5000, n)
    return rows, cols


def load(apis, req_kw, **kw):
    for api, mod in zip(apis, (japi, tapi)):
        api.import_bits(mod.ImportRequest(**req_kw), **kw)


@pytest.fixture(scope="module")
def keyed():
    """Index k (keyed columns) with keyed field f, unkeyed n, int v, time
    t; index u (ids) with set field s and mutex field m."""
    apis = both()
    rng = np.random.default_rng(5)
    users = [f"user{i:04d}" for i in range(300)]
    segs = [f"seg{i}" for i in range(6)]
    for api in apis:
        api.create_index("k", keys=True)
        api.create_field("k", "f", {"keys": True})
        api.create_field("k", "n")
        api.create_field("k", "v", {"type": "int", "min": -50, "max": 1000})
        api.create_field("k", "t", {"type": "time", "timeQuantum": "YMD"})
        api.create_index("u")
        api.create_field("u", "s")
        api.create_field("u", "m", {"type": "mutex"})
    pick = rng.integers(0, 300, 900)
    load(apis, dict(index="k", field="f", column_keys=[users[i] for i in pick],
                    row_keys=[segs[i % 6] for i in rng.integers(0, 6, 900)]))
    load(apis, dict(index="k", field="n", column_keys=[users[i] for i in pick[:200]],
                    row_ids=rng.integers(0, 4, 200).tolist()))
    ts = [int(dt.datetime(2019 + k % 3, 1 + k % 12, 1 + k % 27, tzinfo=dt.timezone.utc)
              .timestamp() * 1e9) for k in range(120)]
    load(apis, dict(index="k", field="t", column_keys=[users[i] for i in pick[:120]],
                    row_ids=[k % 2 for k in range(120)], timestamps=ts))
    values = rng.integers(-50, 1000, 150).tolist()
    for api, mod in zip(apis, (japi, tapi)):
        api.import_values(mod.ImportValueRequest("k", "v", column_keys=users[:150],
                                                 values=values))
    rows, cols = seeded_bits(6, 12, 4000)
    load(apis, dict(index="u", field="s", row_ids=rows, column_ids=cols))
    load(apis, dict(index="u", field="m", row_ids=rows[:500] % 3, column_ids=cols[:500]))
    return apis


KEYED_QUERIES = [
    ("k", 'Row(f="seg1")'),
    ("k", 'Count(Intersect(Row(f="seg1"), Row(f="seg2")))'),
    ("k", 'Count(Union(Row(f="seg0"), Row(n=1))) Count(Difference(Row(f="seg3"), Row(n=2)))'),
    ("k", "TopN(f, n=3)"),
    ("k", 'TopN(f, Row(n=1), n=4)'),
    ("k", "Rows(field=f)"),
    ("k", "GroupBy(Rows(field=f), Rows(field=n))"),
    ("k", 'Options(Row(f="seg4"), excludeColumns=true)'),
    ("k", 'Sum(Row(f="seg1"), field=v)'),
    ("k", "Count(Range(v > 500))"),
    ("k", "Range(t=1, 2019-01-01T00:00, 2020-06-01T00:00)"),
    ("u", "Count(Intersect(Row(s=1), Row(s=2)))"),
    ("u", "Options(Count(Intersect(Row(s=1), Row(s=2))), shards=[0, 2])"),
    ("u", "Options(Row(s=3), shards=[1])"),
    ("u", "Row(m=2)"),
    ("u", "TopN(s, Row(m=1), n=5)"),
]


@pytest.mark.parametrize("index,q", KEYED_QUERIES)
def test_query_matches_the_reference(keyed, index, q):
    ask(keyed, index, q)


def test_request_options_and_attributes(keyed):
    user = query(keyed[1], "k", 'Row(f="seg1")').results[0].keys[3]
    ask(keyed, "k", f'SetColumnAttrs("{user}", tier=2) SetRowAttrs(f, "seg1", label="x")')
    for kw in ({}, {"column_attrs": True}, {"exclude_row_attrs": True},
               {"exclude_columns": True}, {"shards": [0]}):
        ask(keyed, "k", 'Row(f="seg1")', **kw)
    got = ask(keyed, "k", 'Options(Row(f="seg1"), columnAttrs=true)')
    assert [c.to_dict() for c in got.column_attr_sets] == [
        {"key": user, "attrs": {"tier": 2}}]


def test_query_async_answers_as_query(keyed):
    j, t = keyed
    for q in ("Count(Intersect(Row(s=1), Row(s=2))) Count(Row(s=3))",
              "Count(Union(Row(s=4), Row(s=5), Row(m=1)))"):
        fut = t.query_async(tapi.QueryRequest("u", q))
        assert fut is not None
        assert fut.result(timeout=60).results == query(j, "u", q).results
    q = 'Count(Intersect(Row(f="seg1"), Row(f="seg5")))'
    assert t.query_async(tapi.QueryRequest("k", q)).result(timeout=60).results == \
        query(j, "k", q).results
    assert t.query_async(tapi.QueryRequest("u", "Row(s=1)")) is None
    assert t.query_async(tapi.QueryRequest("u", "Count(Row(s=1))", column_attrs=True)) is None


def test_import_clear_and_export(keyed):
    j, t = keyed
    rows, cols = seeded_bits(8, 12, 600)
    load(keyed, dict(index="u", field="s", row_ids=rows, column_ids=cols), clear=True)
    for f in ("s", "m"):
        for shard in (0, 1, 2):
            out = []
            for api in keyed:
                w = io.StringIO()
                api.export_csv("u", f, shard, w)
                out.append(w.getvalue())
            assert out[0] == out[1] and out[0]
    w = [io.StringIO(), io.StringIO()]
    for api, buf in zip(keyed, w):
        api.export_csv("k", "f", 0, buf)
    assert w[0].getvalue() == w[1].getvalue() and "seg" in w[0].getvalue()
    ask(keyed, "u", "Count(Intersect(Row(s=1), Row(s=2)))")
    with pytest.raises(tapi.NotFoundError):
        t.export_csv("u", "s", 99, io.StringIO())


@pytest.mark.parametrize("clear", [False, True], ids=["union", "clear"])
def test_import_roaring_matches_the_reference(clear):
    apis = both()
    rng = np.random.default_rng(12)
    for api in apis:
        api.create_index("r")
        api.create_field("r", "f")
    rows, cols = seeded_bits(13, 6, 3000, shards=(1,))
    load(apis, dict(index="r", field="f", row_ids=rows, column_ids=cols))
    pos = np.unique(rng.integers(0, 6, 5000).astype(np.uint64) * np.uint64(SW)
                    + rng.integers(0, 6000, 5000).astype(np.uint64))
    data = jcodec.serialize(pos)
    n = [api.import_roaring("r", "f", 1, data, clear=clear) for api in apis]
    assert n[0] == n[1] > 0
    for q in ("Row(f=2)", "Count(Intersect(Row(f=0), Row(f=5)))", "Count(Not(Row(f=3)))",
              "TopN(f, n=4)"):
        ask(apis, "r", q)


def test_schema_and_life_cycle():
    apis = both()
    for api in apis:
        api.create_index("a", keys=True)
        api.create_index("b", track_existence=False)
        api.create_field("a", "x", {"keys": True, "cacheSize": 100})
        api.create_field("a", "y", {"type": "int", "min": 0, "max": 9})
        api.create_field("b", "z", {"type": "time", "timeQuantum": "YM"})
    load(apis, dict(index="b", field="z", row_ids=[1, 2], column_ids=[3, 2 * SW + 4],
                    timestamps=[int(1.6e18), 0]))
    j, t = apis
    assert t.schema() == j.schema()
    assert t.views("b", "z") == j.views("b", "z")
    assert t.max_shards() == j.max_shards()
    assert t.available_shards_by_index() == j.available_shards_by_index()
    assert t.info() == j.info()
    assert t.translate_keys("a", "x", ["p", "q", "p"]) == j.translate_keys("a", "x", ["p", "q", "p"])
    assert t.translate_keys("a", "", ["c1"]) == j.translate_keys("a", "", ["c1"])
    view = [v for v in j.views("b", "z") if v != "standard"][0]
    for api in apis:
        api.delete_view("b", "z", view)
        api.delete_field("a", "y")
    assert t.views("b", "z") == j.views("b", "z")
    assert t.schema() == j.schema()
    for api in apis:
        api.delete_index("b")
    assert t.schema() == j.schema()
    assert t.available_shards_by_index() == j.available_shards_by_index()
    for api, mod in zip(apis, (japi, tapi)):
        with pytest.raises(mod.NotFoundError, match="index not found: b"):
            api.index("b")
        with pytest.raises(mod.NotFoundError, match="field not found: y"):
            api.field("a", "y")
        with pytest.raises(mod.NotFoundError, match="view not found"):
            api.delete_view("a", "x", "nope")
    for api, mod in zip(apis, (japi, tapi)):
        api.create_index("plain")
        api.create_field("plain", "f")
        with pytest.raises(mod.ApiError, match="importing keys into unkeyed index"):
            api.import_bits(mod.ImportRequest("plain", "f", row_ids=[1], column_keys=["c"]))
        with pytest.raises(mod.ApiError, match="importing keys into unkeyed field"):
            api.import_bits(mod.ImportRequest("plain", "f", row_keys=["r"], column_ids=[1]))


def test_row_time_matches_the_reference(keyed):
    j, t = keyed
    jf, tf = j.field("k", "t"), t.field("k", "t")
    for q in ("Y", "YM", "YMD", "MD", "D"):
        for when in (dt.datetime(2019, 1, 1), dt.datetime(2020, 2, 2), dt.datetime(2021, 3, 3)):
            for row in (0, 1):
                want = jf.row_time(row, when, q).columns()
                np.testing.assert_array_equal(tf.row_time(row, when, q).columns(), want)
    for bad in ("", "X", "YY"):
        with pytest.raises(ValueError, match="invalid time quantum"):
            tf.row_time(0, dt.datetime(2020, 1, 1), bad)
        with pytest.raises(ValueError, match="invalid time quantum"):
            jf.row_time(0, dt.datetime(2020, 1, 1), bad)


def test_imports_sync_a_resident_stack_in_place():
    """The write path's contract through the API: an import into rows and
    shards a resident stack already holds syncs it in place (one
    ``_scatter_chain``), never rebuilds it."""
    apis = both()
    for api in apis:
        api.create_index("w", keys=True)
        api.create_field("w", "f", {"keys": True})
    keys = [f"c{i}" for i in range(4000)]
    rng = np.random.default_rng(21)
    pick = rng.integers(0, 4000, 6000)
    rk = [("a", "b", "c")[i] for i in rng.integers(0, 3, 6000)]
    load(apis, dict(index="w", field="f", column_keys=[keys[i] for i in pick], row_keys=rk))
    j, t = apis
    q = 'Count(Intersect(Row(f="a"), Row(f="b")))'
    ask(apis, "w", q)  # makes f's stack resident
    eng = t.engine
    rebuilds, updates = eng.stack_rebuilds, eng.stack_updates
    # Keyed import_bits into existing rows and columns.
    load(apis, dict(index="w", field="f", column_keys=keys[:900:3], row_keys=["a"] * 300))
    assert eng.ingest_syncer().flush()
    ask(apis, "w", q)
    assert (eng.stack_rebuilds, eng.stack_updates) == (rebuilds, updates + 1)
    # import_roaring into rows a and b of shard 0 (ids 1 and 2).
    pos = np.unique(np.concatenate([
        np.uint64(r * SW) + rng.integers(0, 4000, 800).astype(np.uint64) for r in (1, 2)]))
    n = [api.import_roaring("w", "f", 0, jcodec.serialize(pos)) for api in apis]
    assert n[0] == n[1] > 0
    assert eng.ingest_syncer().flush()
    ask(apis, "w", q)
    assert (eng.stack_rebuilds, eng.stack_updates) == (rebuilds, updates + 2)
    t.close()


def test_default_device_is_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.API()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.API(translate_store=TranslateFile())


def test_what_is_left_out_raises_naming_its_item():
    t = tapi.API(device="cpu")
    # Item 14's recalculate_caches is ported: a single node re-ranks its
    # caches and has no peer to tell.
    assert t.recalculate_caches() is None
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        t.attach_cluster(None)
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        t.query(tapi.QueryRequest("i", "Count(Row(f=1))", remote=True))
    t.create_index("i").create_field("f")
    plan = t.query(tapi.QueryRequest("i", "Count(Row(f=1))", profile=True)).plan
    assert plan["ops"] == [{"op": "Count", "path": "fast_cardinality"}]
    with pytest.raises(AttributeError):
        t.no_such_method
    t.close()


def test_fast_counts_matches_the_reference():
    """The serving boundary's memo lane: None until every Count of the
    query sits in the result memo, then the counts and a fresh trace id,
    the tenant's query count moved; None again after a write.  An API
    whose executor translates keys never takes the lane, in both."""
    from pilosa_tpu.core.holder import Holder as JHolder
    from pilosa_tpu.parallel import MeshEngine, make_mesh
    from pilosa_tpu.util import plans as jplans
    from pilosa_tpu_torch.util import plans as tplans

    jh = JHolder()
    jh.open()
    j = japi.API(holder=jh, mesh_engine=MeshEngine(jh, make_mesh(1)))
    t = tapi.API(device="cpu")
    rows, cols = seeded_bits(11, 4, 3000)
    q = "Count(Intersect(Row(f=1), Row(f=2))) Count(Union(Row(f=0), Row(f=3)))"
    out = []
    for api, mod, plans in ((j, japi, jplans), (t, tapi, tplans)):
        api.create_index("i").create_field("f").import_bulk(rows.tolist(), cols.tolist())
        api.query(mod.QueryRequest("i", q))
        assert api.fast_counts("i", q) is None  # a translating executor
        api.executor.translator = None
        plans.LEDGER.reset()
        first = api.fast_counts("i", q, "acme")
        # Consecutive Counts run as one batch, which skips the memo (in
        # both): each Count alone stores its answer.
        for one in q.split(" Count"):
            api.query(mod.QueryRequest("i", one if one.startswith("Count") else "Count" + one))
        vals, tid = api.fast_counts("i", q, "acme")
        assert isinstance(tid, str) and len(tid) == 16
        api.query(mod.QueryRequest("i", "Set(3, f=1)"))
        out.append((first, vals, api.fast_counts("i", q, "acme"),
                    plans.LEDGER.snapshot()["acme"]["queries"]))
    assert out[1] == out[0]
    assert out[1][1] == [int(v) for v in t.query(tapi.QueryRequest("i", q)).results]
    t.close()
