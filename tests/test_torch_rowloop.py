"""The port's row-loop imports (``Fragment.bulk_import_rowloop``, its mutex
walk, ``import_roaring_rowloop``) against its vectorized imports and
against the JAX package's row loops (``pilosa_tpu/core/fragment.py:1208,
1249, 1417``) on the same seeded batches: the changed counts, every row's
positions, counts and occupancy, the mutex owners, the write packets the
delta hub receives, and a resident stack synced in place after a row-loop
write.  Counts, positions and words are integers: exact agreement."""

import numpy as np
import pytest

from pilosa_tpu.core.fragment import Fragment as JFragment
from pilosa_tpu.roaring import codec as jcodec
from pilosa_tpu_torch.core.fragment import Fragment as TFragment
from pilosa_tpu_torch.parallel.engine import TorchEngine
from pilosa_tpu_torch.roaring import codec as tcodec

from test_torch_repair import PORT, REF, Side, _packet_fixture, _roaring, mesh1  # noqa: F401

SW = 1 << 20


def port_frag(**kw):
    return TFragment("i", "f", "standard", 0, path=None, device="cpu", **kw)


def ref_frag(**kw):
    return JFragment("i", "f", "standard", 0, path=None, **kw)


def state(f):
    return {r: (f.row_positions(r).tolist(), f.row_count(r), f.row_occupancy(r))
            for r in f.row_ids()}


@pytest.mark.parametrize("seed", range(3))
def test_bulk_import_rowloop_matches_vectorized_and_reference(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    rows = rng.integers(0, 60, n)
    cols = rng.integers(0, SW, n)
    vec, loop, ref = port_frag(), port_frag(), ref_frag()
    got = loop.bulk_import_rowloop(rows.tolist(), cols.tolist())
    assert got == vec.bulk_import(rows, cols) == ref.bulk_import_rowloop(rows.tolist(),
                                                                         cols.tolist())
    assert state(loop) == state(vec) == state(ref)
    # A clear of a random half plus misses (absent rows and columns).
    sel = rng.random(n) < 0.5
    crows = np.concatenate([rows[sel], rng.integers(90, 99, 50)])
    ccols = np.concatenate([cols[sel], rng.integers(0, SW, 50)])
    got = loop.bulk_import_rowloop(crows.tolist(), ccols.tolist(), clear=True)
    assert got == vec.bulk_import(crows, ccols, clear=True) == ref.bulk_import_rowloop(
        crows.tolist(), ccols.tolist(), clear=True)
    assert state(loop) == state(vec) == state(ref)
    assert loop.bulk_import_rowloop([], []) == 0


def test_bulk_import_rowloop_dense_rows():
    """Rows past the sparse limit take the store's dense form, and clear
    back below it."""
    rng = np.random.default_rng(3)
    vec, loop, ref = port_frag(), port_frag(), ref_frag()
    for _ in range(3):
        cols = rng.integers(0, 40000, 3000)
        rows = np.zeros(cols.size, dtype=np.int64)
        assert (loop.bulk_import_rowloop(rows.tolist(), cols.tolist())
                == vec.bulk_import(rows, cols)
                == ref.bulk_import_rowloop(rows.tolist(), cols.tolist()))
    half = loop.row_positions(0)[: loop.row_positions(0).size // 2].astype(np.int64)
    zeros = [0] * half.size
    assert (loop.bulk_import_rowloop(zeros, half.tolist(), clear=True)
            == vec.bulk_import(np.zeros(half.size, np.int64), half, clear=True)
            == ref.bulk_import_rowloop(zeros, half.tolist(), clear=True))
    assert state(loop) == state(vec) == state(ref)


def test_mutex_rowloop_last_write_wins():
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 20, 1200)
    cols = rng.integers(0, 2000, 1200)  # heavy column collisions
    vec, loop, ref = port_frag(mutex=True), port_frag(mutex=True), ref_frag(mutex=True)
    for batch in (slice(0, 700), slice(700, 1200)):  # the second moves owners
        r, c = rows[batch], cols[batch]
        assert (loop.bulk_import_rowloop(r.tolist(), c.tolist()) == vec.bulk_import(r, c)
                == ref.bulk_import_rowloop(r.tolist(), c.tolist()))
        assert state(loop) == state(vec) == state(ref)
    for col in np.unique(cols).tolist():
        assert loop.row_containing(col) == vec.row_containing(col) == ref.row_containing(col)
    # A clear import bypasses the mutex walk and drops the owners it clears.
    r, c = rows[:300], cols[:300]
    assert (loop.bulk_import_rowloop(r.tolist(), c.tolist(), clear=True)
            == vec.bulk_import(r, c, clear=True)
            == ref.bulk_import_rowloop(r.tolist(), c.tolist(), clear=True))
    assert state(loop) == state(vec) == state(ref)


@pytest.mark.parametrize("clear", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_import_roaring_rowloop_matches_vectorized_and_reference(seed, clear):
    rng = np.random.default_rng(40 + seed)
    base = np.unique(rng.integers(0, 8, 4000).astype(np.uint64) * SW
                     + rng.integers(0, SW, 4000).astype(np.uint64))
    body = np.unique(np.concatenate([
        base[rng.random(base.size) < 0.5],
        rng.integers(0, 12, 3000).astype(np.uint64) * SW + rng.integers(0, SW, 3000).astype(
            np.uint64),
        5 * SW + np.arange(70000, dtype=np.uint64)]))  # one dense row
    data = tcodec.serialize(body)
    assert data == jcodec.serialize(body)
    vec, loop, ref = port_frag(), port_frag(), ref_frag()
    for f in (vec, loop, ref):
        f.import_roaring(tcodec.serialize(base) if f is not ref else jcodec.serialize(base))
    got = loop.import_roaring_rowloop(data, clear=clear)
    assert got == vec.import_roaring(data, clear=clear) == ref.import_roaring_rowloop(
        data, clear=clear)
    assert state(loop) == state(vec) == state(ref)


ROWLOOP_WRITES = {
    "bulk_import_rowloop": lambda h, d: h.fragment("p", "f", "standard", 1).bulk_import_rowloop(
        [1, 2, 3, 3], [SW + 5, SW + 70, SW + 71, int(d["f"][d["f"] >= SW][0])]),
    "bulk_import_rowloop_clear": lambda h, d: h.fragment(
        "p", "f", "standard", 0).bulk_import_rowloop([1, 2, 3], d["f"][d["f"] < SW][:3].tolist(),
                                                     clear=True),
    "bulk_import_rowloop_mutex": lambda h, d: h.fragment(
        "p", "m", "standard", 0).bulk_import_rowloop([1, 2, 1], d["m"][d["m"] < SW][:3].tolist()),
}


def _rowloop_packets(side, name):
    h, d = _packet_fixture(side)
    if name == "import_roaring_rowloop":
        field = "f"
        write = lambda: h.fragment("p", "f", "standard", 0).import_roaring_rowloop(  # noqa: E731
            _roaring(side, [1, 5], 40, 8))
    else:
        field = "m" if name.endswith("mutex") else "f"
        write = lambda: ROWLOOP_WRITES[name](h, d)  # noqa: E731
    vobj = h.index("p").field(field).views["standard"]
    vkey = ("p", field, "standard", vobj.gen)
    base = vobj.version
    side.HUB.subscribe(vkey, base)
    try:
        changed = write()
        pk = side.HUB.packets_for(vkey, base, vobj.version)
    finally:
        side.HUB.unsubscribe(vkey)
    assert pk is not None and len(pk) >= 1
    rows = {r: h.fragment("p", field, "standard", s).row_positions(r).tolist()
            for s in (0, 1) for r in h.fragment("p", field, "standard", s).row_ids()}
    return changed, rows, [(p.version, p.shard, p.opaque) for p in pk]


@pytest.mark.parametrize("name", list(ROWLOOP_WRITES) + ["import_roaring_rowloop"])
def test_rowloop_packets_as_the_reference(mesh1, name):  # noqa: F811
    """A row loop publishes one packet per row it touches, OPAQUE as the
    reference's (it stages no before-words), so a repair falls back to a
    recompute: the same changed count, rows and packets in both packages."""
    ref = _rowloop_packets(Side(REF, mesh1), name)
    port = _rowloop_packets(Side(PORT, mesh1), name)
    assert port == ref
    assert all(opaque for _, _, opaque in port[2])


def test_rowloop_write_syncs_a_resident_stack_in_place():
    """A row-loop write logs its rows' dirty words like the vectorized
    import: the next Count syncs the resident stack in place (no rebuild)
    and sees the write; a memo entry over the view is not served stale."""
    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.core.holder import Holder

    h = Holder(device="cpu")
    h.open()
    f = h.create_index("i").create_field("f")
    f.import_bulk([1, 1, 2, 2], [3, SW + 4, 5, SW + 6])
    eng = TorchEngine(h, device="cpu")
    try:
        call = pql.parse("Intersect(Row(f=1), Row(f=2))").calls[0]
        assert eng.count("i", call, [0, 1]) == 0
        rebuilds, updates = eng.stack_rebuilds, eng.stack_updates
        frag = h.fragment("i", "f", "standard", 1)
        assert frag.bulk_import_rowloop([1, 2, 2], [SW + 9, SW + 9, SW + 4]) == 3
        assert eng.count("i", call, [0, 1]) == 2
        assert (eng.stack_rebuilds, eng.stack_updates) == (rebuilds, updates + 1)
        data = tcodec.serialize(np.asarray([1 * SW + 3, 2 * SW + 3], dtype=np.uint64))
        assert h.fragment("i", "f", "standard", 0).import_roaring_rowloop(data) == 1
        assert eng.count("i", call, [0, 1]) == 3
        assert eng.stack_rebuilds == rebuilds
    finally:
        eng.close()
