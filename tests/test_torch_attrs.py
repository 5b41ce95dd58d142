"""Row and column attributes in the port (pilosa_tpu_torch.core.attrs and
the executor's attribute lanes) against the JAX package.

- ``AttrStore`` round-trips on disk and in memory, and its anti-entropy
  blocks (``blocks()`` checksums and ``block_data()``) equal the
  reference's byte for byte; a store file the reference wrote reads the
  same.
- ``SetRowAttrs`` (one call, and the bulk lane of a query of them alone)
  and ``SetColumnAttrs`` leave the reference's attributes.
- ``Row`` results carry their row's attributes unless ``excludeRowAttrs``;
  ``columnAttrs`` returns the reference's column attribute sets.
- TopN with ``attrName``/``attrValues`` (string, int and bool values, rows
  without the attribute) equals the reference's fused and host executors
  on a seeded twin index: the port's fused TopN declines it, K3 scores the
  candidates and ``Fragment.top`` filters.

Attributes, ids and counts are discrete: exact agreement (tolerance 0)."""

import numpy as np
import pytest

from pilosa_tpu.core.attrs import AttrStore as JAttrStore
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import ExecOptions as JExecOptions
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu_torch.core.attrs import ATTR_BLOCK_SIZE
from pilosa_tpu_torch.core.attrs import AttrStore as TAttrStore
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor import ExecOptions as TExecOptions
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.parallel.engine import TorchEngine

N_SHARDS = 4
SW = 1 << 20


def attr_writes(seed=2):
    """A seeded sequence of set_attrs / set_bulk_attrs calls over ids in
    five blocks: strings, ints, floats, bools, lists, and None deletes."""
    rng = np.random.default_rng(seed)
    values = ["red", "blue", 3, -7, 2.5, True, False, [1, "a"], None]
    out = []
    for _ in range(60):
        ids = rng.integers(0, 5 * ATTR_BLOCK_SIZE, int(rng.integers(1, 6))).tolist()
        m = {i: {f"k{int(rng.integers(0, 4))}": values[int(rng.integers(0, len(values)))]
                 for _ in range(int(rng.integers(1, 3)))} for i in ids}
        out.append(m)
    return out


def write(store, writes):
    for k, m in enumerate(writes):
        if k % 2:
            store.set_bulk_attrs(m)
        else:
            for i, a in m.items():
                store.set_attrs(i, a)


@pytest.mark.parametrize("on_disk", [False, True], ids=["memory", "disk"])
def test_store_blocks_equal_the_references(tmp_path, on_disk):
    jp = str(tmp_path / "j" / ".data") if on_disk else None
    tp = str(tmp_path / "t" / ".data") if on_disk else None
    j, t = JAttrStore(jp), TAttrStore(tp)
    writes = attr_writes()
    write(j, writes)
    write(t, writes)
    assert t.blocks() == j.blocks()
    assert len(t.blocks()) >= 4
    for blk, _ in j.blocks():
        assert t.block_data(blk) == j.block_data(blk)
    for i in range(5 * ATTR_BLOCK_SIZE):
        assert t.attrs(i) == j.attrs(i)
    if on_disk:
        t.close()
        t = TAttrStore(tp)  # reopened: from the file, not the cache
        assert t.blocks() == j.blocks()
        assert all(t.attrs(i) == j.attrs(i) for i in range(5 * ATTR_BLOCK_SIZE))
    j.close()
    t.close()


def test_reads_a_store_file_the_reference_wrote(tmp_path):
    p = str(tmp_path / ".data")
    j = JAttrStore(p)
    write(j, attr_writes(seed=4))
    want = [(i, j.attrs(i)) for i in range(5 * ATTR_BLOCK_SIZE)]
    blocks = j.blocks()
    j.close()
    t = TAttrStore(p)
    assert [(i, t.attrs(i)) for i in range(5 * ATTR_BLOCK_SIZE)] == want
    assert t.blocks() == blocks
    t.set_attrs(7, {"k9": "new"})
    t.close()
    j = JAttrStore(p)
    assert j.attrs(7)["k9"] == "new"
    j.close()


# -- the executor's attribute lanes ------------------------------------------


def topn_data(seed=9):
    """Field t: rows 1..24, density growing with the row id, over
    N_SHARDS shards; field w: src rows 1 (dense) and 2 (sparse)."""
    rng = np.random.default_rng(seed)
    out = {}
    rows, cols = [], []
    for s in range(N_SHARDS):
        for r in range(1, 25):
            pos = rng.choice(2048, 20 + 9 * r + int(rng.integers(0, 5)), replace=False)
            rows.append(np.full(pos.size, r))
            cols.append(s * SW + pos)
    out["t"] = (np.concatenate(rows), np.concatenate(cols))
    rows, cols = [], []
    for s in range(N_SHARDS):
        for r, size in ((1, 1500), (2, 120)):
            pos = rng.choice(2048, size, replace=False)
            rows.append(np.full(pos.size, r))
            cols.append(s * SW + pos)
    out["w"] = (np.concatenate(rows), np.concatenate(cols))
    return out


# Rows 21..24 (the densest) carry no attribute at all.
ROW_ATTRS = " ".join(
    f'SetRowAttrs(t, {r}, cat="{"abc"[r % 3]}", level={r % 4}, flag={"true" if r % 2 else "false"})'
    for r in range(1, 21))


def build(holder):
    idx = holder.create_index("i")
    every = set()
    for field, (rows, cols) in topn_data().items():
        idx.create_field(field).import_bulk(rows.tolist(), cols.tolist())
        every.update(cols.tolist())
    idx.add_column_existence(sorted(every))
    return holder


@pytest.fixture(scope="module")
def trio():
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    build(jh)
    build(th)
    exs = (JExecutor(jh, mesh_engine=MeshEngine(jh, make_mesh(8))), JExecutor(jh),
           Executor(th, engine=TorchEngine(th, device="cpu")))
    exs[1].execute("i", ROW_ATTRS)
    exs[2].execute("i", ROW_ATTRS)
    return jh, th, exs


def test_set_row_attrs_single_and_bulk(trio):
    jh, th, (_, host, port) = trio
    jt, tt = jh.index("i").field("t"), th.index("i").field("t")
    # The bulk lane (a query of SetRowAttrs alone) left the same attributes.
    assert tt.row_attr_store.blocks() == jt.row_attr_store.blocks()
    q = 'Set(3, w=1) SetRowAttrs(w, 1, name="dense", level=null)'
    assert port.execute("i", q).results == host.execute("i", q).results == [True, None]
    assert th.index("i").field("w").row_attr_store.attrs(1) == \
        jh.index("i").field("w").row_attr_store.attrs(1) == {"name": "dense"}
    q = 'SetRowAttrs(w, 2, a=1) SetRowAttrs(w, 2, b="x") SetRowAttrs(t, 22, a=2)'
    assert port.execute("i", q).results == host.execute("i", q).results == [None] * 3
    for f in ("w", "t"):
        assert th.index("i").field(f).row_attr_store.blocks() == \
            jh.index("i").field(f).row_attr_store.blocks()


def test_set_column_attrs(trio):
    jh, th, (_, host, port) = trio
    q = f'SetColumnAttrs(5, color="red", n=3) SetColumnAttrs({SW + 9}, ok=true)'
    q += ' SetColumnAttrs(5, n=null)'
    assert port.execute("i", q).results == host.execute("i", q).results
    assert th.index("i").column_attr_store.blocks() == jh.index("i").column_attr_store.blocks()
    assert th.index("i").column_attr_store.attrs(5) == {"color": "red"}


@pytest.mark.parametrize("q,opt", [
    ("Row(t=4)", None),
    ("Row(t=23)", None),
    ("Row(t=4)", "exclude_row_attrs"),
    ("Options(Row(t=5), excludeRowAttrs=true)", None),
    ("Options(Row(t=5), excludeColumns=true)", None),
    ("Row(t=6)", "exclude_columns"),
    ("Intersect(Row(t=4), Row(w=1))", None),
])
def test_row_attrs_on_row_results(trio, q, opt):
    _, _, (_, host, port) = trio
    kw = {opt: True} if opt else {}
    want = host.execute("i", q, opt=JExecOptions(**kw)).results[0]
    got = port.execute("i", q, opt=TExecOptions(**kw)).results[0]
    assert got.attrs == want.attrs
    np.testing.assert_array_equal(got.columns(), want.columns())


def column_sets(resp):
    return None if resp.column_attr_sets is None else [c.to_dict() for c in resp.column_attr_sets]


@pytest.mark.parametrize("q,column_attrs", [
    ("Row(t=1)", True),
    ("Row(t=1) Row(w=2)", True),
    ("Options(Row(t=2), columnAttrs=true)", False),
    ("Row(t=1)", False),
    ("Count(Row(t=1))", True),
])
def test_column_attrs(trio, q, column_attrs):
    _, _, (_, host, port) = trio
    cols = host.execute("i", "Row(t=1)").results[0].columns().tolist()
    writes = " ".join(f'SetColumnAttrs({c}, pick={k % 3})' for k, c in enumerate(cols[:40:3]))
    host.execute("i", writes)
    port.execute("i", writes)
    want = host.execute("i", q, opt=JExecOptions(column_attrs=column_attrs))
    got = port.execute("i", q, opt=TExecOptions(column_attrs=column_attrs))
    assert column_sets(got) == column_sets(want)
    if (column_attrs or "columnAttrs" in q) and not q.startswith("Count"):
        assert column_sets(got)


TOPN_FILTERED = [
    'TopN(t, Row(w=1), n=3, attrName="cat", attrValues=["a"])',
    'TopN(t, Row(w=1), n=5, attrName="cat", attrValues=["a", "c"])',
    'TopN(t, Row(w=2), n=4, attrName="level", attrValues=[0, 3])',
    'TopN(t, Row(w=1), n=3, attrName="flag", attrValues=[true])',
    'TopN(t, Row(w=1), n=0, attrName="flag", attrValues=[false])',
    'TopN(t, Row(w=1), n=3, attrName="missing", attrValues=["a"])',
    'TopN(t, Row(w=1), n=3, attrName="cat", attrValues=["z"])',
    'TopN(t, Row(w=1), n=3, threshold=50, attrName="cat", attrValues=["b"])',
    'TopN(t, Intersect(Row(w=1), Row(w=2)), n=2, attrName="level", attrValues=[1, 2])',
    'TopN(t, n=4, attrName="cat", attrValues=["b"])',
]


@pytest.mark.parametrize("shards", [None, [0, 3]], ids=["all", "subset"])
@pytest.mark.parametrize("q", TOPN_FILTERED)
def test_topn_attribute_filter(trio, q, shards):
    _, _, (fused, host, port) = trio
    want = [tuple(p) for p in fused.execute("i", q, shards=shards).results[0]]
    assert [tuple(p) for p in host.execute("i", q, shards=shards).results[0]] == want
    assert [tuple(p) for p in port.execute("i", q, shards=shards).results[0]] == want
    # The densest rows carry no attribute: a filter never returns them.
    assert not {21, 22, 23, 24} & {r for r, _ in want}
