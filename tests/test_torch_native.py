"""The port's native host code (``pilosa_tpu_torch/native``: the C++ roaring
codec and sparse merge, built with g++ into ``build/native/``) against its
numpy paths, the port's row-loop oracle and the JAX package's codec, after
the reference's ``tests/test_native_codec.py`` and
``tests/test_native_merge.py``: the native bytes and decodes equal the
reference codec's and the numpy paths', the merges and the shard split
give bit-identical stores and groupings, and the numpy paths take over
when the library is absent.  Bytes, positions and counts:
exact agreement."""

import struct

import numpy as np
import pytest

from pilosa_tpu.roaring import codec as jcodec
from pilosa_tpu_torch import native
from pilosa_tpu_torch.core import rowstore
from pilosa_tpu_torch.core.field import Field
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.roaring import codec

pytestmark = pytest.mark.skipif(native.load() is None or native.load_merge() is None,
                                reason="no C++ toolchain on this host")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_values(rng, n, span=1 << 22):
    return np.unique(rng.choice(span, size=n, replace=False).astype(np.uint64))


def frag(**kw):
    return Fragment("t", "f", "standard", 0, path=None, device="cpu", **kw)


def assert_same_store(fa, fb, ctx=""):
    assert fa.row_ids() == fb.row_ids(), ctx
    for r in fa.row_ids():
        np.testing.assert_array_equal(fa.row_positions(r), fb.row_positions(r),
                                      err_msg=f"{ctx} row {r}")
        assert fa.row_count(r) == fb.row_count(r), (ctx, r)
    assert sorted(fa.cache.top()) == sorted(fb.cache.top()), ctx


# -- the codec -----------------------------------------------------------------

def test_libraries_build_under_build_native():
    for name in ("roaring_codec", "sparse_merge"):
        path = native.lib_path(name)
        assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
        assert "pilosa_tpu/native" not in str(path)


@pytest.mark.parametrize("n", [0, 1, 100, 5000, 60000])
def test_serialize_matches_numpy_and_reference(rng, n):
    vals = random_values(rng, n) if n else np.empty(0, dtype=np.uint64)
    got = codec.serialize(vals)
    assert got == codec._serialize_py(vals) == jcodec.serialize(vals) == jcodec._serialize_py(vals)


def test_serialize_run_heavy_matches_numpy():
    vals = np.concatenate([np.arange(0, 30000, dtype=np.uint64),
                           np.arange(1 << 16, (1 << 16) + 5, dtype=np.uint64)])
    assert codec.serialize(vals) == codec._serialize_py(vals) == jcodec.serialize(vals)


def test_roundtrip_native_decode(rng):
    vals = random_values(rng, 20000)
    data = codec.serialize(vals)
    for dec in (codec.deserialize(data), codec._deserialize_np(data),
                codec._deserialize_py(data), jcodec.deserialize(data)):
        np.testing.assert_array_equal(dec.values, vals)


def test_native_op_log_replay():
    data = codec.serialize(np.array([1, 2, 3], dtype=np.uint64))
    data += codec.encode_op(codec.OP_TYPE_ADD, 10)
    data += codec.encode_op(codec.OP_TYPE_REMOVE, 2)
    data += codec.encode_op(codec.OP_TYPE_ADD, 2)
    dec = codec.deserialize(data)
    assert dec.values.tolist() == [1, 2, 3, 10] and dec.op_n == 3
    assert dec.values.tolist() == codec._deserialize_np(data).values.tolist()
    assert dec.op_n == jcodec.deserialize(data).op_n


def test_native_rejects_corrupt_op():
    data = codec.serialize(np.array([1], dtype=np.uint64))
    op = bytearray(codec.encode_op(codec.OP_TYPE_ADD, 9))
    op[-1] ^= 0xFF  # a bad checksum
    with pytest.raises(ValueError):
        codec.deserialize(data + bytes(op))


def test_native_decodes_official_format(rng):
    lows = sorted(rng.choice(1 << 16, size=100, replace=False).tolist())
    body = struct.pack("<II", codec.OFFICIAL_COOKIE_NO_RUN, 1)
    body += struct.pack("<HH", 5, len(lows) - 1)  # key 5
    body += struct.pack("<I", len(body) + 4)
    body += np.array(lows, dtype="<u2").tobytes()
    want = (np.uint64(5) << np.uint64(16)) | np.array(lows, dtype=np.uint64)
    np.testing.assert_array_equal(codec.deserialize(body).values, want)
    np.testing.assert_array_equal(codec._deserialize_np(body).values, want)


def test_codec_falls_back_without_the_library(rng, monkeypatch):
    vals = random_values(rng, 3000, span=1 << 30)
    with_native = codec.serialize(vals)
    monkeypatch.setattr(native, "load", lambda: None)
    assert codec.serialize(vals) == with_native
    np.testing.assert_array_equal(codec.deserialize(with_native).values, vals)


# -- the merge -----------------------------------------------------------------

@pytest.mark.parametrize("n_rows,mutex", [(4, False), (64, False), (5000, False), (48, True)],
                         ids=["dense-promote", "mid", "sparse-wide", "mutex-lww"])
def test_bulk_import_three_way_differential(rng, monkeypatch, n_rows, mutex):
    """bulk_import on the native merge == on the numpy merge ==
    bulk_import_rowloop, across unions, clears, fresh rows and dense and
    sparse promotions."""
    frags = [frag(mutex=mutex) for _ in range(3)]
    for i in range(6):
        n_bits = int(rng.integers(2000, 30000))
        rows = rng.integers(0, n_rows, n_bits).astype(np.int64)
        cols = rng.integers(0, 1 << 20, n_bits).astype(np.int64)
        clear = (not mutex) and i in (3, 5)
        changed = []
        for k, f in enumerate(frags):
            monkeypatch.setattr(rowstore, "_MERGE", False if k == 1 else None)
            if k == 2:
                changed.append(f.bulk_import_rowloop(rows, cols, clear=clear))
            else:
                changed.append(f.bulk_import(rows, cols, clear=clear))
        assert changed[0] == changed[1] == changed[2], (i, changed)
        assert rowstore._merge_lib() is not None
        assert_same_store(frags[0], frags[1], f"native-vs-numpy {i}")
        assert_same_store(frags[0], frags[2], f"native-vs-rowloop {i}")


def test_import_roaring_differential(rng, monkeypatch):
    fa, fb, fc = frag(), frag(), frag()
    for i in range(3):
        rows = rng.integers(0, 700, 20000).astype(np.uint64)
        cols = rng.integers(0, 1 << 20, 20000).astype(np.uint64)
        data = codec.serialize(np.unique((rows << np.uint64(20)) | cols))
        monkeypatch.setattr(rowstore, "_MERGE", None)
        ca = fa.import_roaring(data, clear=i == 2)
        monkeypatch.setattr(rowstore, "_MERGE", False)
        cc = fc.import_roaring(data, clear=i == 2)
        assert ca == cc == fb.import_roaring_rowloop(data, clear=i == 2), i
    assert_same_store(fa, fb, "roaring")
    assert_same_store(fa, fc, "roaring numpy")


def test_apply_dense_matches_numpy(rng, monkeypatch):
    for clear in (False, True):
        d = rng.integers(0, 1 << 63, rowstore.WORDS64, dtype=np.uint64)
        pos = np.unique(rng.integers(0, 1 << 20, 5000)).astype(np.uint32)
        a, b = d.copy(), d.copy()
        monkeypatch.setattr(rowstore, "_MERGE", None)
        da = rowstore.RowStore._apply_dense(a, pos, clear)
        monkeypatch.setattr(rowstore, "_MERGE", False)
        db = rowstore.RowStore._apply_dense(b, pos, clear)
        assert da == db and np.array_equal(a, b)


def test_fallback_is_automatic_when_loader_absent(rng, monkeypatch):
    rows = rng.integers(0, 100, 8000).astype(np.int64)
    cols = rng.integers(0, 1 << 20, 8000).astype(np.int64)
    fa = frag()
    monkeypatch.setattr(native, "load_merge", lambda: None)
    monkeypatch.setattr(rowstore, "_MERGE", None)  # resolve again
    assert rowstore._merge_lib() is None
    fa.bulk_import(rows, cols)
    monkeypatch.undo()
    fb = frag()
    fb.bulk_import(rows, cols)
    assert_same_store(fa, fb, "loader absent")


def test_decoded_bound_sizes_every_decode(rng):
    """The decode's one pass writes into a buffer that rc_decoded_bound
    sizes from the headers alone: the bound covers the count of every
    format (runs, arrays and bitmaps; an op log of adds; the official
    layouts), and bytes of no format are refused before any decode."""
    lib = native.load()
    dense = np.unique(rng.integers(0, 3 << 16, 150000).astype(np.uint64))
    runs = np.concatenate([np.arange(k << 16, (k << 16) + 40000, dtype=np.uint64)
                           for k in range(3)])
    ops = b"".join(codec.encode_op(codec.OP_TYPE_ADD, v) for v in (7 << 20, 8 << 20, 9 << 20))
    lows = np.arange(0, 5000, 3, dtype="<u2")
    official = (struct.pack("<II", codec.OFFICIAL_COOKIE_NO_RUN, 1)
                + struct.pack("<HH", 2, lows.size - 1) + struct.pack("<I", 16) + lows.tobytes())
    for data in (codec.serialize(dense), codec.serialize(runs),
                 codec.serialize(random_values(rng, 3000)) + ops, official):
        want = codec._deserialize_np(data).values
        assert lib.rc_decoded_bound(data, len(data)) >= want.size
        np.testing.assert_array_equal(codec.deserialize(data).values, want)
    assert lib.rc_decoded_bound(b"\x00" * 16, 16) < 0


# -- the shard split -----------------------------------------------------------

def _groups(field, cols, rows):
    return [(f.shard, c.tolist(), r.tolist())
            for f, c, r in Field._shard_groups(field.view_if_not_exists("standard"), cols, rows)]


@pytest.mark.parametrize("wide", [False, True])
def test_shard_split_native_matches_argsort(rng, monkeypatch, wide):
    """Field._shard_groups: the native counting sort and the argsort give
    the same (shard, slices) groups, order within a shard included; a
    batch over two shards far apart (past the table's direct bound) still
    takes the native path."""
    n = 40000
    rows = rng.integers(0, 500, n).astype(np.int64)
    if wide:
        far = (Field._NATIVE_SPLIT_MAX_SHARDS + 7) << 20
        cols = np.where(rng.random(n) < 0.5, rng.integers(0, 1 << 20, n),
                        rng.integers(far, far + (1 << 20), n)).astype(np.int64)
    else:
        cols = rng.integers(0, 6 << 20, n).astype(np.int64)
    holder = Holder(device="cpu")
    holder.open()
    idx = holder.create_index("split")
    fa, fb = idx.create_field("fa"), idx.create_field("fb")
    calls = []
    real = Field._shard_groups_native
    monkeypatch.setattr(Field, "_shard_groups_native",
                        staticmethod(lambda *a: calls.append(1) or real(*a)))
    monkeypatch.setattr(rowstore, "_MERGE", None)
    ga = _groups(fa, cols, rows)
    monkeypatch.setattr(rowstore, "_MERGE", False)
    gb = _groups(fb, cols, rows)
    assert ga == gb and calls == [1]
    if wide:
        assert {s for s, _, _ in ga} == {0, Field._NATIVE_SPLIT_MAX_SHARDS + 7}
    holder.close()


def test_field_import_through_native_matches_numpy(rng, monkeypatch):
    """Field.import_bulk and import_values over several shards: the same
    fragments with the native library as without it."""
    rows = rng.integers(0, 40, 20000).astype(np.int64)
    cols = rng.integers(0, 5 << 20, 20000).astype(np.int64)
    vals = rng.integers(0, 1000, 20000).astype(np.int64)
    out = []
    for lib in (None, False):
        monkeypatch.setattr(rowstore, "_MERGE", lib)
        from pilosa_tpu_torch.core.field import FieldOptions

        h = Holder(device="cpu")
        h.open()
        idx = h.create_index("i")
        f = idx.create_field("f")
        f.import_bulk(rows.tolist(), cols.tolist())
        v = idx.create_field("v", FieldOptions(type="int", min=0, max=1000))
        v.import_values(cols.tolist(), vals.tolist())
        out.append({(fld, s): {r: h.fragment("i", fld, view, s).row_positions(r).tolist()
                               for r in h.fragment("i", fld, view, s).row_ids()}
                    for fld, view in (("f", "standard"), ("v", "bsig_v")) for s in range(5)})
        h.close()
    assert out[0] == out[1]
