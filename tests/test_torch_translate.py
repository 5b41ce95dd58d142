"""Key translation in the port (pilosa_tpu_torch.core.translate and
.executor.translate) against the JAX package's, on the same key sequences
and the same queries.

- ``TranslateFile`` assigns the reference's ids, writes the reference's log
  bytes, reopens from its log and from its sidecar (replaying the same
  tail), and reads a ``.keys`` log and sidecar that the reference wrote.
- ``QueryTranslator`` rewrites keyed Set/Clear/Row/Count/TopN/Rows/GroupBy/
  Range/SetColumnAttrs calls and bool rows to the reference's ids, turns
  results back into the reference's keys, and raises the reference's
  errors, message for message.

Keys, ids and counts are discrete: exact agreement (tolerance 0)."""

import numpy as np
import pytest

from pilosa_tpu import pql as jpql
from pilosa_tpu.core import translate as jtr
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.executor.translate import QueryTranslator as JQueryTranslator
from pilosa_tpu.executor.translate import TranslateError as JTranslateError
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.convert import open_translate_store
from pilosa_tpu_torch.core import translate as ttr
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.executor import RowIdentifiers
from pilosa_tpu_torch.executor.translate import QueryTranslator as TQueryTranslator
from pilosa_tpu_torch.executor.translate import TranslateError as TTranslateError


def key_batches(seed=3, n_batches=12):
    """(kind, index, field, keys) batches: columns of two indexes and rows of
    three fields, keys drawn with repeats within and across batches."""
    rng = np.random.default_rng(seed)
    pool = [f"key-{i:05d}-{'x' * int(rng.integers(0, 40))}" for i in range(3000)]
    out = []
    for b in range(n_batches):
        kind = ("col", "row")[b % 2]
        index = ("i", "j")[int(rng.integers(0, 2))]
        field = "" if kind == "col" else ("f", "g", "h")[int(rng.integers(0, 3))]
        keys = [pool[k] for k in rng.integers(0, len(pool), int(rng.integers(1, 900)))]
        out.append((kind, index, field, keys))
    return out


def apply(store, batches):
    ids = []
    for kind, index, field, keys in batches:
        if kind == "col":
            ids.append(store.translate_columns_to_uint64(index, keys))
        else:
            ids.append(store.translate_rows_to_uint64(index, field, keys))
    return ids


def reverse(store, batches):
    out = []
    for kind, index, field, keys in batches:
        for i in range(0, 1200, 7):
            out.append(store.translate_column_to_string(index, i) if kind == "col"
                       else store.translate_row_to_string(index, field, i))
    return out


def test_same_ids_and_log_bytes_in_memory():
    batches = key_batches()
    j, t = jtr.TranslateFile(), ttr.TranslateFile()
    assert apply(t, batches) == apply(j, batches)
    assert reverse(t, batches) == reverse(j, batches)
    assert t.size() == j.size()
    assert bytes(t._log._buf) == bytes(j._log._buf)


@pytest.mark.parametrize("sidecar", [True, False], ids=["sidecar", "log-only"])
def test_reopen_from_log_and_sidecar(tmp_path, sidecar):
    """Both packages write a log, checkpoint (or not), append a tail, and
    reopen: the same bytes replayed, the same ids and keys after."""
    batches = key_batches(seed=5)
    half = len(batches) // 2
    stores = {}
    for name, mod in (("jax", jtr), ("port", ttr)):
        p = str(tmp_path / f"{name}.keys")
        s = mod.TranslateFile(p)
        s.open()
        apply(s, batches[:half])
        if sidecar:
            s.checkpoint()
        apply(s, batches[half:])
        s._log.close()  # no checkpoint at close: the tail stays unindexed
        s = mod.TranslateFile(p)
        s.open()
        stores[name] = s
    j, t = stores["jax"], stores["port"]
    assert t.replayed_bytes == j.replayed_bytes
    assert (t.replayed_bytes < j.size()) == sidecar
    assert reverse(t, batches) == reverse(j, batches)
    more = key_batches(seed=6, n_batches=4)
    assert apply(t, more) == apply(j, more)
    with open(str(tmp_path / "jax.keys"), "rb") as a, open(str(tmp_path / "port.keys"), "rb") as b:
        assert a.read() == b.read()
    j.close()
    t.close()


def test_reads_a_keys_file_the_reference_wrote(tmp_path):
    p = str(tmp_path / ".keys")
    batches = key_batches(seed=7)
    j = jtr.TranslateFile(p)
    j.open()
    want_ids = apply(j, batches[:8])
    j.close()  # checkpoints the sidecar
    j = jtr.TranslateFile(p)
    j.open()
    apply(j, batches[8:])  # a tail past the sidecar's watermark
    want_rev = reverse(j, batches)
    j._log.close()
    t = open_translate_store(p)
    assert 0 < t.replayed_bytes < t.size()
    assert apply(t, batches[:8]) == want_ids
    assert reverse(t, batches) == want_rev
    # New keys continue the reference's sequences.
    j = jtr.TranslateFile(p + ".twin")
    j.open()
    with open(p, "rb") as f:
        j._log.append(f.read())
    j._log.close()
    j = jtr.TranslateFile(p + ".twin")
    j.open()
    more = key_batches(seed=8, n_batches=4)
    assert apply(t, more) == apply(j, more)
    t.close()


def test_hash_collisions_resolve_like_the_reference(monkeypatch):
    """Every key on one bucket: probing and the key compare in the log
    still give each key its id."""
    monkeypatch.setattr(ttr, "_hash", lambda kb: 7)
    monkeypatch.setattr(jtr, "_hash", lambda kb: 7)
    keys = [f"k{i}" for i in range(60)]
    j, t = jtr.TranslateFile(), ttr.TranslateFile()
    for s in (j, t):
        s.translate_columns_to_uint64("i", keys)
    assert t.translate_columns_to_uint64("i", keys[::-1]) == \
        j.translate_columns_to_uint64("i", keys[::-1])
    assert t.translate_columns_to_uint64("i", ["fresh"]) == [61]


# -- QueryTranslator ---------------------------------------------------------


def keyed_twin(holder_cls, opts_cls):
    h = holder_cls(device="cpu") if holder_cls is THolder else holder_cls()
    h.open()
    idx = h.create_index("i", keys=True)
    idx.create_field("f", opts_cls(keys=True))
    idx.create_field("g", opts_cls(keys=True))
    idx.create_field("n")
    idx.create_field("b", opts_cls(type="bool"))
    idx.create_field("v", opts_cls(type="int", min=0, max=100))
    idx.create_field("t", opts_cls(type="time", time_quantum="YMD", keys=True))
    u = h.create_index("u")
    u.create_field("f")
    u.create_field("k", opts_cls(keys=True))
    return h


@pytest.fixture()
def twins():
    jh = keyed_twin(JHolder, JFieldOptions)
    th = keyed_twin(THolder, TFieldOptions)
    jex = JExecutor(jh, translator=JQueryTranslator(jtr.TranslateFile()))
    tex = TExecutor(th, translator=TQueryTranslator(ttr.TranslateFile()))
    return jh, th, jex, tex


CALLS = [
    ("i", 'Set("alpha", f="ten")'),
    ("i", 'Clear("alpha", f="ten")'),
    ("i", 'Row(f="ten")'),
    ("i", 'Count(Intersect(Row(f="ten"), Row(g="x")))'),
    ("i", 'TopN(f, Row(g="x"), n=2)'),
    ("i", 'Rows(field=f, previous="ten", column="beta")'),
    ("i", 'GroupBy(Rows(field=f), Rows(field=n), previous=["ten", 3])'),
    ("i", 'Range(t="ten", 2010-01-01T00:00, 2011-01-01T00:00)'),
    ("i", 'SetColumnAttrs("beta", color="red")'),
    ("i", 'SetRowAttrs(f, "eleven", cat=1)'),
    ("i", 'Row(b=true)'),
    ("i", 'Union(Row(b=false), Row(n=4))'),
    ("i", 'Count(Range(v > 10))'),
    ("u", 'Set(5, k="kk")'),
    ("u", 'Row(f=1)'),
]


@pytest.mark.parametrize("index,q", CALLS)
def test_calls_translate_to_the_references_ids(twins, index, q):
    jh, th, jex, tex = twins
    jcalls = jpql.parse(q).calls
    tcalls = tpql.parse(q).calls
    for _ in range(2):  # the second pass sees the ids the first assigned
        jex.translator.translate_calls(index, jh.index(index), jcalls)
        tex.translator.translate_calls(index, th.index(index), tcalls)
        assert [str(c) for c in tcalls] == [str(c) for c in jcalls]
        jcalls, tcalls = jpql.parse(q).calls, tpql.parse(q).calls


def test_results_translate_to_the_references_keys(twins):
    jh, th, jex, tex = twins
    writes = " ".join(f'Set("c{c}", f="r{c % 3}") Set("c{c}", g="s{c % 2}")'
                      for c in range(12))
    writes += ' Set("c1", n=7) Set("c2", n=9) Set("c3", b=true)'
    for ex in (jex, tex):
        ex.execute("i", writes)
    for q in ('Row(f="r1")', 'Union(Row(f="r0"), Row(g="s1"))', 'TopN(f, n=3)',
              'TopN(f, Row(g="s0"), n=2)', "Rows(field=f)", "Rows(field=n)",
              'Rows(field=g, previous="s0")',
              "GroupBy(Rows(field=f), Rows(field=g))",
              'GroupBy(Rows(field=f), Rows(field=g), previous=["r0", "s1"])',
              'Count(Intersect(Row(f="r2"), Row(g="s0")))', "Row(b=true)"):
        want = jex.execute("i", q).results[0]
        got = tex.execute("i", q).results[0]
        if hasattr(want, "columns"):
            assert got.keys == want.keys, q
            np.testing.assert_array_equal(got.columns(), want.columns())
        elif isinstance(want, list) and want and hasattr(want[0], "group"):
            assert [g.to_dict() for g in got] == [g.to_dict() for g in want], q
        elif hasattr(want, "rows"):
            assert isinstance(got, RowIdentifiers)
            assert (got.rows, got.keys) == (want.rows, want.keys), q
        else:
            assert got == want, q


BAD = [
    ("i", "Set(1, f=\"x\")"),
    ("i", 'Set("c", f=3)'),
    ("u", 'Set("c", f=1)'),
    ("u", 'Row(f="x")'),
    ("i", 'Row(b="true")'),
    ("i", "Row(b=1)"),
    ("i", 'GroupBy(Rows(field=f), previous="x")'),
    ("i", 'GroupBy(Rows(field=f), previous=["x", "y"])'),
    ("i", "GroupBy(Rows(field=f), previous=[1])"),
    ("i", 'GroupBy(Rows(field=n), previous=["x"])'),
    ("i", 'GroupBy(Rows(field=nope), previous=["x"])'),
]


@pytest.mark.parametrize("index,q", BAD)
def test_errors_match_the_references(twins, index, q):
    _, _, jex, tex = twins
    with pytest.raises(JTranslateError) as want:
        jex.execute(index, q)
    with pytest.raises(TTranslateError) as got:
        tex.execute(index, q)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("on_disk", [False, True], ids=["memory", "disk"])
def test_bulk_reverse_lookup_equals_the_references_one_by_one(tmp_path, on_disk):
    """``translate_columns_to_strings`` (a Row result's keys under one
    lock) gives the reference's ``translate_column_to_string`` of each id,
    "" for ids with no key, before and after the log grows."""
    batches = [b for b in key_batches(seed=9) if b[0] == "col"]
    j = jtr.TranslateFile()
    t = ttr.TranslateFile(str(tmp_path / ".keys") if on_disk else None)
    t.open()
    ids = np.arange(0, 1500)
    for k in range(0, len(batches), 2):
        apply(j, batches[k:k + 2])
        apply(t, batches[k:k + 2])
        for index in ("i", "j", "none"):
            assert t.translate_columns_to_strings(index, ids) == \
                [j.translate_column_to_string(index, int(i)) for i in ids]
    t.close()
