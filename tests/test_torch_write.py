"""The port's write path (fragment write logs, ``sync_snapshot`` and the
engine's in-place sync of resident stacks) against the JAX package, on
the same seeded Holders and the same writes in both.

- ``Fragment.sync_snapshot`` equals the reference's after random
  sequences of set, clear, bulk import, set_value and ``load_row_words``,
  word-log compaction and whole-row rows included.
- After each write, the port's resident stack (words and occupancy)
  equals a fresh rebuild and the JAX ``MeshEngine``'s synced stack;
  counts equal both JAX executors; neither engine rebuilt, and both
  counted a stack update.
- A Set into an empty block of a block-clustered field is counted on
  the sparse path; a new row, a new shard, a replaced fragment or a
  storage load rebuilds on both engines; ``IngestSyncer`` syncs only
  resident stacks; TopN after writes equals both JAX executors.

Counts and words are integers: exact agreement (tolerance 0).  On the
CPU the scatter is ``index_put_`` on the CPU tensor, the same call the
card runs."""

import numpy as np
import pytest
import torch

from pilosa_tpu.core.fragment import Fragment as JFragment
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu_torch.core.fragment import Fragment as TFragment
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.parallel.engine import TorchEngine

N_SHARDS = 3
SW = bitops.SHARD_WIDTH
BLOCK = bitops.OCC_BLOCK_BITS
CLUSTER_BLOCKS = (3, 9, 40, 41)
EMPTY_BLOCK = 20  # no row of field c has a bit here


def seeded_data(seed=23):
    """{field: (rows, cols)}: d dense (rows 1..4, every block occupied),
    c clustered into CLUSTER_BLOCKS, t rows of growing density for TopN
    and w its src rows."""
    rng = np.random.default_rng(seed)
    data = {}
    for field in ("d", "c", "t", "w"):
        rows, cols = [], []
        for s in range(N_SHARDS):
            if field == "d":
                spec = [(r, rng.choice(SW, 6000, replace=False)) for r in (1, 2, 3, 4)]
            elif field == "c":
                spec = [(r, b * BLOCK + rng.choice(BLOCK, 300, replace=False))
                        for r in (1, 2, 3) for b in CLUSTER_BLOCKS]
            elif field == "t":
                spec = [(r, rng.choice(4096, 10 + 12 * r, replace=False)) for r in range(1, 13)]
            else:
                spec = [(5, rng.choice(4096, 2400, replace=False)),
                        (6, rng.choice(4096, 600, replace=False))]
            for r, pos in spec:
                rows.append(np.full(pos.size, r))
                cols.append(s * SW + pos)
        data[field] = (np.concatenate(rows), np.concatenate(cols))
    return data


def fill(holder, data):
    idx = holder.create_index("i")
    every = set()
    for field, (rows, cols) in data.items():
        idx.create_field(field).import_bulk(rows.tolist(), cols.tolist())
        every.update(cols.tolist())
    idx.add_column_existence(sorted(every))
    return holder


class Twins:
    """One seeded index in both packages, each with its engine and
    executors: the JAX fused and host executors, the port's executor."""

    def __init__(self):
        data = seeded_data()
        self.jh = JHolder()
        self.jh.open()
        self.th = THolder(device="cpu")
        self.th.open()
        fill(self.jh, data)
        fill(self.th, data)
        self.jeng = MeshEngine(self.jh, make_mesh(8))
        self.teng = TorchEngine(self.th, device="cpu")
        self.fused = JExecutor(self.jh, mesh_engine=self.jeng)
        self.host = JExecutor(self.jh)
        self.port = Executor(self.th, engine=self.teng)

    def write(self, q):
        """One write query through both packages' executors."""
        got = self.port.execute("i", q).results
        assert got == self.fused.execute("i", q).results
        return got

    def both(self, fn):
        """``fn(holder)`` on the JAX holder, then the port's."""
        fn(self.jh)
        fn(self.th)

    def stacks(self, *fields):
        """Make the fields' stacks resident on both engines."""
        for f in fields:
            self.jeng.field_stack("i", f, "standard")
            self.teng.field_stack("i", f, "standard")

    def counters(self):
        return (self.jeng.stack_rebuilds, self.jeng.stack_updates,
                self.teng.stack_rebuilds, self.teng.stack_updates)

    def count(self, q):
        """Count(q) from all three executors, equal; the port's answer."""
        want = self.fused.execute("i", f"Count({q})").results[0]
        assert self.host.execute("i", f"Count({q})").results[0] == want
        got = self.port.execute("i", f"Count({q})").results[0]
        assert got == want, q
        return got


def assert_stack_current(tw, field):
    """The port's resident stack equals a fresh rebuild and the JAX
    engine's synced stack, row by row (a row a Clear emptied stays in a
    synced stack as zeros, and leaves a rebuild's row table)."""
    st = tw.teng.field_stack("i", field, "standard")
    fresh = TorchEngine(tw.th, device="cpu").field_stack("i", field, "standard")
    jst = tw.jeng.field_stack("i", field, "standard")
    words = st.matrix.numpy().view(np.uint32)
    fwords = fresh.matrix.numpy().view(np.uint32)
    S = len(st.shards)
    jwords = np.asarray(jst.matrix)[:, :S]
    jocc = np.asarray(jst.occ)[:, :S]
    assert st.row_index == jst.row_index and st.shards == jst.shards
    for r, i in st.row_index.items():
        j = fresh.row_index.get(r)
        if j is None:
            assert not words[i].any() and not st.occ[i].any(), r
        else:
            np.testing.assert_array_equal(words[i], fwords[j], err_msg=f"row {r}")
            np.testing.assert_array_equal(st.occ[i], fresh.occ[j], err_msg=f"occ {r}")
        np.testing.assert_array_equal(words[i], jwords[jst.row_index[r]])
        np.testing.assert_array_equal(st.occ[i], jocc[jst.row_index[r]])
    return st


# -- (a) sync_snapshot ------------------------------------------------------


def same_snapshot(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a[0] == b[0]
    assert sorted(a[1]) == sorted(b[1])
    for r in a[1]:
        x, y = a[1][r], b[1][r]
        assert x[0] == y[0] and int(x[-1]) == int(y[-1]), (r, x[0], y[0])
        for p, q in zip(x[1:-1], y[1:-1]):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("global_max", [None, 3000], ids=["default", "dedup"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sync_snapshot_matches_reference(seed, global_max):
    """Random writes to one fragment in each package; every few writes the
    snapshot from a random earlier sync point must agree.  Runs past
    WORD_LOG_RECORDS records (tail compaction into tiers); bulk imports of
    more than WORD_LOG_MAX words of one row ship the row whole; "dedup"
    lowers WORD_LOG_GLOBAL_MAX so the whole log dedups and turns its
    largest rows whole-row dirty."""
    rng = np.random.default_rng(seed)
    j = JFragment("i", "f", "standard", 0)
    t = TFragment("i", "f", "standard", 0, device="cpu")
    if global_max is not None:
        j.WORD_LOG_GLOBAL_MAX = t.WORD_LOG_GLOBAL_MAX = global_max
    for step in range(160):
        op = int(rng.integers(0, 6))
        if op == 0:
            r, c = int(rng.integers(0, 6)), int(rng.integers(0, SW))
            assert j.set_bit(r, c) == t.set_bit(r, c)
        elif op == 1:
            r, c = int(rng.integers(0, 6)), int(rng.integers(0, SW))
            assert j.clear_bit(r, c) == t.clear_bit(r, c)
        elif op in (2, 3):
            # Up to ~8000 columns of one row: past WORD_LOG_MAX words.
            n = int(rng.integers(1, 8000))
            rows = rng.integers(0, 6, n) if op == 2 else np.full(n, int(rng.integers(0, 6)))
            cols = rng.integers(0, SW, n)
            clear = bool(rng.integers(0, 2)) and op == 2
            j.bulk_import(rows, cols, clear=clear)
            t.bulk_import(rows, cols, clear=clear)
        elif op == 4:
            c, val = int(rng.integers(0, SW)), int(rng.integers(0, 1 << 10))
            assert j.set_value(c, 10, val) == t.set_value(c, 10, val)
        else:
            w = rng.integers(0, 1 << 64, bitops.WORDS // 2, dtype=np.uint64)
            r = int(rng.integers(20, 23))
            j.load_row_words(r, w.copy())
            t.load_row_words(r, w.copy())
        assert t._version == j._version
        if step % 5 == 0:
            for back in {0, int(rng.integers(0, t._version + 1)), t._version - 1, t._version}:
                same_snapshot(t.sync_snapshot(back), j.sync_snapshot(back))
    assert t._mutlog == j._mutlog
    assert t._word_floor == j._word_floor
    assert t._word_log_tiers == j._word_log_tiers
    assert [v for v, _ in t._word_log] == [v for v, _ in j._word_log]


def test_storage_load_sets_the_floor(tmp_path):
    """A fragment reopened from its storage file cannot sync from before
    the load: the snapshot is None in both packages, and from the load's
    own version on it is empty."""
    out = []
    for cls, kw, sub in ((JFragment, {}, "j"), (TFragment, {"device": "cpu"}, "t")):
        path = str(tmp_path / sub)
        f = cls("i", "f", "standard", 0, path=path, **kw)
        for c in (1, 70000, 900000):
            f.set_bit(3, c)
        f.close()
        g = cls("i", "f", "standard", 0, path=path, **kw)  # loads the file
        assert g._mut_floor == g._version > 0
        out.append((g.sync_snapshot(g._version - 1), g.sync_snapshot(g._version)))
        g.set_bit(4, 5)
        out.append(g.sync_snapshot(g._mut_floor))
        g.close()
    assert out[0][0] is None and out[2][0] is None
    assert out[0][1] == out[2][1] == (out[0][1][0], {})
    same_snapshot(out[1], out[3])


# -- (b) in-place sync after each write ---------------------------------------


def free_col(tw, field, rows, shard=0, block=None):
    """A column of ``shard`` (in ``block`` if given) where none of ``rows``
    of ``field`` has a bit."""
    frag = tw.th.fragment("i", field, "standard", shard)
    lo = 0 if block is None else block * BLOCK
    for pos in range(lo + 7, lo + BLOCK):
        if not any(frag.bit(r, shard * SW + pos) for r in rows):
            return shard * SW + pos
    raise AssertionError("no free column")


def set_col(tw, field, rows, shard=0):
    """A column of ``shard`` where every one of ``rows`` of ``field`` has
    a bit."""
    frag = tw.th.fragment("i", field, "standard", shard)
    pos = frag.row(rows[0]).columns()
    for c in pos.tolist():
        if all(frag.bit(r, c) for r in rows):
            return c
    raise AssertionError("no shared column")


WRITES = ["set_d", "clear_d", "set_c_empty_block", "clear_c_block", "import_d",
          "import_clear_d", "load_row_words_d", "set_then_clear", "clear_row_d",
          "clear_row_c", "store_d", "store_c"]


def same_row_words(tw, field, row):
    """The row's host words equal in both packages, shard by shard."""
    for s in range(N_SHARDS):
        jf, tf = tw.jh.fragment("i", field, "standard", s), tw.th.fragment("i", field, "standard", s)
        np.testing.assert_array_equal(tf.row_words(row), jf.row_words(row),
                                      err_msg=f"{field}={row}, shard {s}")
        assert tf.row_count(row) == jf.row_count(row)


@pytest.mark.parametrize("write", WRITES)
def test_write_syncs_the_resident_stack_in_place(write):
    tw = Twins()
    field = "c" if write in ("set_c_empty_block", "clear_c_block") else "d"
    q = f"Intersect(Row({field}=1), Row({field}=2))"
    tw.stacks(field)
    c0 = tw.count(q)
    before = tw.counters()
    delta = None
    if write == "set_d":
        col = free_col(tw, "d", (1, 2), shard=1)
        tw.write(f"Set({col}, d=1)")
        tw.write(f"Set({col}, d=2)")
        delta = 1
    elif write == "clear_d":
        tw.write(f"Clear({set_col(tw, 'd', (1, 2), shard=2)}, d=2)")
        delta = -1
    elif write == "set_c_empty_block":
        col = free_col(tw, "c", (1, 2), shard=1, block=EMPTY_BLOCK)
        tw.write(f"Set({col}, c=1)")
        tw.write(f"Set({col}, c=2)")
        delta = 1
    elif write == "clear_c_block":
        # Empty one block of row 1 on shard 0: its occupancy bit clears.
        frag = tw.th.fragment("i", "c", "standard", 0)
        occ = frag._store.occupancy64(1)
        b = next(b for b in CLUSTER_BLOCKS if occ >> b & 1)
        cols = [c for c in frag.row(1).columns().tolist() if c // BLOCK == b]
        tw.both(lambda h: h.index("i").field("c").import_bulk([1] * len(cols), cols,
                                                              clear=True))
    elif write in ("import_d", "import_clear_d"):
        rng = np.random.default_rng(5)
        rows = rng.integers(1, 5, 5000).tolist()
        cols = rng.integers(0, N_SHARDS * SW, 5000).tolist()
        tw.both(lambda h: h.index("i").field("d").import_bulk(
            rows, cols, clear=write == "import_clear_d"))
    elif write == "load_row_words_d":
        w = np.random.default_rng(9).integers(0, 1 << 64, bitops.WORDS // 2, dtype=np.uint64)
        tw.both(lambda h: h.fragment("i", "d", "standard", 1).load_row_words(2, w.copy()))
    elif write in ("clear_row_d", "clear_row_c"):
        assert tw.write(f"ClearRow({field}=2)") == [True]
        assert tw.write(f"ClearRow({field}=2)") == [False]
        same_row_words(tw, field, 2)
        delta = -c0
    elif write in ("store_d", "store_c"):
        # Row 2 becomes Row 1 & Row 3: the Intersect counts 1 & 3.
        assert tw.write(f"Store(Intersect(Row({field}=1), Row({field}=3)), {field}=2)") == [True]
        assert tw.write(f"Store(Intersect(Row({field}=1), Row({field}=3)), {field}=2)") == [False]
        same_row_words(tw, field, 2)
        delta = tw.count(f"Intersect(Row({field}=1), Row({field}=3))") - c0
    else:
        col = free_col(tw, "d", (1, 2))
        tw.write(f"Set({col}, d=1)")
        tw.write(f"Set({col}, d=2)")
        tw.write(f"Clear({col}, d=1)")
        delta = 0
    got = tw.count(q)
    if delta is not None:
        assert got == c0 + delta
    st = assert_stack_current(tw, field)
    jr, ju, tr, tu = tw.counters()
    assert (jr, tr) == before[0::2], "a write rebuilt a stack"
    assert ju > before[1] and tu > before[3]
    if write == "clear_c_block":
        assert not st.occ[st.row_index[1], 0] >> np.uint64(b) & np.uint64(1)
    # Every other tree over the field still agrees.
    for q2 in (f"Union(Row({field}=1), Row({field}=3))",
               f"Difference(Row({field}=2), Row({field}=1))",
               f"Xor(Row({field}=1), Row({field}=2))"):
        tw.count(q2)


def test_store_and_clear_row_stale_the_memo_and_match_the_reference():
    """A memoized Count misses after a Store or a ClearRow and sees it (the
    repair layer serves both from their deltas); a Store of a new row adds
    the row (a rebuild, as for any new row); the Store into an existing
    row and a ClearRow sync the stack in place."""
    tw = Twins()
    tw.stacks("d")
    q = "Intersect(Row(d=1), Row(d=2))"
    tw.count(q)
    hits = tw.teng.result_memo.hits
    c0 = tw.count(q)
    assert tw.teng.result_memo.hits == hits + 1
    before = tw.counters()
    tw.write("Store(Union(Row(c=1), Row(d=4)), d=2)")
    c1 = tw.count(q)
    assert c1 != c0 and tw.teng.result_memo.hits == hits + 1
    tw.write("ClearRow(d=1)")
    assert tw.count(q) == 0
    assert tw.teng.repairs.repaired["count"] == 2
    assert_stack_current(tw, "d")
    _, _, tr, tu = tw.counters()
    assert tr == before[2] and tu > before[3]
    # Store into a row no fragment had: the stack grows a row.
    tw.write("Store(Row(d=3), d=9)")
    same_row_words(tw, "d", 9)
    assert tw.count("Intersect(Row(d=9), Row(d=3))") == tw.count("Row(d=3)")
    assert tw.counters()[2] == tr + 1
    assert_stack_current(tw, "d")
    # Rows sees the cleared and the stored rows as the reference does.
    for rq in ("Rows(field=d)", "Rows(field=d, previous=1)"):
        assert tw.port.execute("i", rq).results == tw.fused.execute("i", rq).results


def test_store_and_clear_row_errors_match_the_reference():
    from pilosa_tpu.core.field import FieldOptions as JFieldOptions
    from pilosa_tpu.executor.executor import Error as JError
    from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
    from pilosa_tpu_torch.executor.executor import Error as TError

    tw = Twins()
    for name, opts in (("v", dict(type="int", min=0, max=9)),
                       ("m", dict(type="mutex")), ("b", dict(type="bool")),
                       ("tq", dict(type="time", time_quantum="YMD"))):
        tw.jh.index("i").create_field(name, JFieldOptions(**opts))
        tw.th.index("i").create_field(name, TFieldOptions(**opts))
    for q in ("ClearRow(v=1)", "Store(Row(d=1), v=1)", "Store(Row(d=1), m=1)",
              "Store(Row(d=1), b=1)", "Store(Row(d=1), tq=1)", "Store(d=1)",
              "Store(Row(d=1))", "Store(Row(d=1), Row(d=2), d=3)"):
        with pytest.raises(JError) as want:
            tw.fused.execute("i", q)
        with pytest.raises(TError) as got:
            tw.port.execute("i", q)
        assert str(got.value) == str(want.value), q
    # ClearRow takes set, time, mutex and bool fields, as the reference.
    tw.write("Set(5, m=1) Set(6, b=1) Set(7, tq=2, 2018-01-02T00:00)")
    for q in ("ClearRow(m=1)", "ClearRow(b=1)", "ClearRow(tq=2)"):
        assert tw.write(q) == [True]
    q = "Count(Range(tq=2, 2018-01-01T00:00, 2019-01-01T00:00))"
    assert tw.port.execute("i", q).results == tw.fused.execute("i", q).results == [0]


# -- (c) occupancy: a Set into an empty block on the sparse path ------------


def test_set_into_an_empty_block_is_counted_on_the_sparse_path():
    tw = Twins()
    # Repair-on-write would serve every re-count below with no dispatch
    # (tests/test_torch_repair.py holds that); this test pins the sparse
    # path's sync, so its Counts must dispatch.
    tw.teng.repairs._suspended = 1
    q = "Intersect(Row(c=1), Row(c=2))"
    c0 = tw.count(q)
    assert tw.teng.last_path == "sparse"
    col = free_col(tw, "c", (1, 2), shard=2, block=EMPTY_BLOCK)
    st = tw.teng.field_stack("i", "c", "standard")
    bit = np.uint64(1) << np.uint64(EMPTY_BLOCK)
    assert not (st.occ[:, 2] & bit).any()
    tw.write(f"Set({col}, c=1)")
    assert tw.count(q) == c0
    tw.write(f"Set({col}, c=2)")
    assert tw.count(q) == c0 + 1
    assert tw.teng.last_path == "sparse"
    assert st.occ[st.row_index[1], 2] & bit and st.occ[st.row_index[2], 2] & bit
    tw.write(f"Clear({col}, c=1)")
    assert tw.count(q) == c0
    assert not st.occ[st.row_index[1], 2] & bit
    assert tw.teng.stack_rebuilds == 1 and tw.teng.stack_updates == 3


# -- (d) what only a rebuild covers -------------------------------------------


@pytest.mark.parametrize("case", ["new_row", "new_shard", "replaced_fragment",
                                  "storage_load"])
def test_changes_of_shape_or_source_rebuild_on_both(case):
    tw = Twins()
    q = "Intersect(Row(d=1), Row(d=2))"
    tw.stacks("d")
    tw.count(q)
    before = tw.counters()
    if case == "new_row":
        tw.write("Set(77, d=9)")
    elif case == "new_shard":
        tw.write(f"Set({N_SHARDS * SW + 5}, d=1)")
    elif case == "replaced_fragment":
        def replace(h):
            view = h.index("i").field("d").view("standard")
            old = view.fragments.pop(1)
            new = view.fragment_if_not_exists(1)
            for r in old.row_ids():
                cols = old.row(r).columns()
                new.bulk_import(np.full(cols.size, r), cols)
            new.set_bit(1, SW + 3)
            new.set_bit(2, SW + 3)
        tw.both(replace)
    else:
        # A load into a live fragment (the reference loads only at open,
        # and bumps no view version there: bump it by hand).
        pos = np.asarray([2 * SW + 11, 1 * SW + 11], dtype=np.uint64)
        tw.jh.fragment("i", "d", "standard", 1)._load_positions(pos)
        tw.jh.view("i", "d", "standard")._bump_version()
        tw.th.fragment("i", "d", "standard", 1)._load_positions(pos)
    tw.count(q)
    tw.count("Union(Row(d=1), Row(d=9))")
    assert_stack_current(tw, "d")
    jr, ju, tr, tu = tw.counters()
    assert (jr, tr) == (before[0] + 1, before[2] + 1)
    assert (ju, tu) == before[1::2]


def test_sibling_field_shard_epoch_does_not_rebuild():
    """A new fragment in another field bumps the index's shard epoch; the
    resident stack of d syncs its own write and is not rebuilt."""
    tw = Twins()
    q = "Intersect(Row(d=1), Row(d=2))"
    tw.stacks("d")
    c0 = tw.count(q)
    before = tw.counters()
    col = free_col(tw, "d", (1, 2), shard=1)
    tw.write(f"Set({col}, d=1)")
    tw.write(f"Set({col}, d=2)")
    tw.both(lambda h: h.index("i").create_field("z").set_bit(1, 4))
    assert tw.count(q) == c0 + 1
    assert tw.counters()[0::2] == before[0::2]


# -- (e) IngestSyncer ----------------------------------------------------------


def test_ingest_syncer_syncs_only_resident_stacks():
    tw = Twins()
    tw.stacks("d")
    rng = np.random.default_rng(3)
    rows = rng.integers(1, 5, 2000).tolist()
    cols = rng.integers(0, N_SHARDS * SW, 2000).tolist()
    for h in (tw.jh, tw.th):
        for f in ("d", "c"):
            h.index("i").field(f).import_bulk(rows, cols)
    before = tw.counters()
    for eng in (tw.jeng, tw.teng):
        syncer = eng.ingest_syncer()
        syncer.notify("i")
        syncer.notify("i")
        assert syncer.flush(timeout=60)
        assert syncer.stacks_synced >= 1 and syncer.chunks == 2
        assert 1 <= syncer.syncs <= 2 and syncer.coalesced <= 1
    # Synced without a query, and c (never queried) never admitted.
    jr, ju, tr, tu = tw.counters()
    assert (jr, tr) == before[0::2] and ju == before[1] + 1 and tu == before[3] + 1
    assert ("i", "c", "standard") not in tw.teng._stacks
    assert ("i", "c", "standard") not in tw.jeng._stacks
    view = tw.th.view("i", "d", "standard")
    st = tw.teng._stacks[("i", "d", "standard")]
    assert st.versions[2] == view.version
    assert_stack_current(tw, "d")
    tw.count("Intersect(Row(d=1), Row(d=3))")
    syncer = tw.teng.ingest_syncer()
    tw.teng.close()
    assert not syncer._thread.is_alive()
    syncer.notify("i")  # after close: ignored
    assert syncer.chunks == 2 and not tw.teng._stacks
    tw.jeng.close()


# -- (f) TopN after writes --------------------------------------------------


TOPN_QUERIES = ["TopN(t, Row(w=5), n=3)", "TopN(t, Row(w=6), n=5)",
                "TopN(t, Row(w=5))", "TopN(t, Row(w=5), ids=[2, 4, 11])",
                "TopN(t, Intersect(Row(w=5), Row(w=6)), n=2, threshold=3)"]


@pytest.mark.parametrize("q", TOPN_QUERIES)
def test_topn_after_writes_matches_both_jax_executors(q):
    """Writes lift row 2 of t over the others inside w's columns; each
    TopN after them equals both JAX executors, with no rebuild."""
    tw = Twins()

    def topn():
        want = tw.fused.execute("i", q).results[0]
        assert tw.host.execute("i", q).results[0] == want
        got = tw.port.execute("i", q).results[0]
        assert [tuple(p) for p in got] == [tuple(p) for p in want], q
        return got

    first = topn()
    rebuilds = tw.teng.stack_rebuilds
    frag_w = tw.th.fragment("i", "w", "standard", 0)
    cols = frag_w.row(5).columns().tolist()[:400]
    tw.both(lambda h: h.index("i").field("t").import_bulk([2] * len(cols), cols))
    for c in cols[:5]:
        tw.write(f"Clear({c}, t=12)")
    after = topn()
    assert tw.teng.stack_rebuilds == rebuilds and tw.teng.stack_updates >= 1
    if q == "TopN(t, Row(w=5), n=3)":
        assert after[0][0] == 2 and after != first


# -- (g) a Set followed by a fused Count (__graft_entry__.py's write check) ---


def test_set_then_fused_count_sees_the_bit_without_a_rebuild():
    tw = Twins()
    q = "Intersect(Row(d=1), Row(d=2))"
    c0 = tw.count(q)
    rebuilds = tw.teng.stack_rebuilds
    frag = tw.th.fragment("i", "d", "standard", 0)
    col = next(c for c in frag.row(2).columns().tolist() if not frag.bit(1, c))
    tw.write(f"Set({col}, d=1)")
    assert tw.count(q) == c0 + 1
    assert tw.teng.stack_rebuilds == rebuilds, "write forced a stack rebuild"
    assert tw.teng.last_path == "dense"


def test_failed_scatter_evicts_the_stack_and_raises(monkeypatch):
    """A scatter that raises leaves no stack behind: the error reaches the
    caller, and the next query rebuilds from host truth."""
    tw = Twins()
    q = "Intersect(Row(d=1), Row(d=2))"
    c0 = tw.count(q)
    col = free_col(tw, "d", (1, 2))
    tw.both(lambda h: h.index("i").field("d").set_bit(1, col))
    tw.both(lambda h: h.index("i").field("d").set_bit(2, col))

    def boom(*a, **k):
        raise RuntimeError("scatter failed")

    monkeypatch.setattr(TorchEngine, "_scatter_chain", boom)
    with pytest.raises(RuntimeError, match="scatter failed"):
        tw.teng.field_stack("i", "d", "standard")
    assert ("i", "d", "standard") not in tw.teng._stacks
    monkeypatch.undo()
    rebuilds = tw.teng.stack_rebuilds
    with tw.teng.repairs.suspended():  # the query must dispatch to rebuild
        assert tw.count(q) == c0 + 1
    assert tw.teng.stack_rebuilds == rebuilds + 1


def test_scatter_moves_only_changed_words(monkeypatch):
    """A point write ships the changed word, not the 128 KiB row: the
    sync's index_put_ carries one word per written (row, shard)."""
    tw = Twins()
    tw.stacks("d")
    seen = []
    orig = torch.Tensor.index_put_

    def spy(self, indices, values, *a, **k):
        seen.append((len(indices), tuple(values.shape)))
        return orig(self, indices, values, *a, **k)

    monkeypatch.setattr(torch.Tensor, "index_put_", spy)
    col = free_col(tw, "d", (1,), shard=2)
    tw.th.index("i").field("d").set_bit(1, col)
    tw.teng.field_stack("i", "d", "standard")
    assert seen == [(3, (1,))]
    seen.clear()
    w = np.ones(bitops.WORDS // 2, dtype=np.uint64)
    tw.th.fragment("i", "d", "standard", 0).load_row_words(3, w)
    tw.teng.field_stack("i", "d", "standard")
    assert seen == [(2, (1, bitops.WORDS))]


def test_concurrent_writes_queries_and_ingest_worker_agree():
    """Writer threads Set bits while reader threads count and the ingest
    worker syncs, under a short switch interval.  Every reader sees a
    count that never falls; afterwards every written bit is counted, the
    resident stack equals a fresh rebuild, and nothing was rebuilt."""
    import sys
    import threading

    th = THolder(device="cpu")
    th.open()
    rows, cols = seeded_data()["d"]
    th.create_index("i").create_field("d").import_bulk(rows.tolist(), cols.tolist())
    eng = TorchEngine(th, device="cpu")
    call = Executor(th)._parse_cached("Intersect(Row(d=1), Row(d=2))").calls[0]
    shards = list(range(N_SHARDS))
    c0 = eng.count("i", call, shards)
    field = th.index("i").field("d")
    frags = [th.fragment("i", "d", "standard", s) for s in shards]
    free = [s * SW + p for s in shards for p in range(0, SW, 997)
            if not frags[s].bit(1, s * SW + p) and not frags[s].bit(2, s * SW + p)][:480]
    syncer = eng.ingest_syncer()
    done = threading.Event()
    seen, errors = [], []

    def write(mine):
        try:
            for k, col in enumerate(mine):
                field.set_bit(1, col)
                field.set_bit(2, col)
                if k % 20 == 0:
                    syncer.notify("i")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def read():
        last = c0
        try:
            while not done.is_set():
                n = eng.count("i", call, shards)
                if n < last:
                    errors.append(AssertionError(f"count fell from {last} to {n}"))
                last = n
                seen.append(n)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        writers = [threading.Thread(target=write, args=(free[t::4],)) for t in range(4)]
        readers = [threading.Thread(target=read) for _ in range(2)]
        for t in writers + readers:
            t.start()
        for t in writers:
            t.join(timeout=60)
        done.set()
        for t in readers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in writers + readers)
        assert syncer.flush(timeout=60)
    finally:
        sys.setswitchinterval(old)
        syncer.close()
    assert not errors, errors[:3]
    assert seen and all(c0 <= n <= c0 + len(free) for n in seen)
    assert eng.count("i", call, shards) == c0 + len(free)
    st = eng.field_stack("i", "d", "standard")
    fresh = TorchEngine(th, device="cpu").field_stack("i", "d", "standard")
    assert st.row_index == fresh.row_index
    assert torch.equal(st.matrix, fresh.matrix)
    np.testing.assert_array_equal(st.occ, fresh.occ)
    assert eng.stack_rebuilds == 1 and eng.stack_updates >= 1
