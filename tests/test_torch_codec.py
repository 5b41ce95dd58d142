"""Fragment bodies by rows (pilosa_tpu_torch.roaring.codec.serialize_rows
and decode_rows) against the JAX package's codec, and the port's
fragments that open, import and snapshot dense rows as words, against
pilosa_tpu's fragments and API on the same bytes.

- ``serialize_rows`` writes the bytes of ``pilosa_tpu``'s
  ``codec.serialize`` for rows of every container type (dense random
  bitmaps, long runs, a dense store row below the array limit, sparse
  rows, rows that mix the three);
- ``decode_rows`` gives back the bits that ``codec.deserialize`` decodes,
  rows of more than 4096 bits as words, and declines (None) a body with
  an op-log, a body of rows of few bits only and the official format; a body cut in its header raises, one cut
  in its payload is declined to ``deserialize``, which raises;
- a fragment file written by ``pilosa_tpu``'s Fragment opens in the
  port's with the same rows and counts, and the port's ``import_roaring``
  of a dense body changes as many bits and writes the same file bytes as
  the reference's, union and clear;
- through the API, a dense ``import_roaring`` answers as the reference
  and syncs a resident stack in place (``stack_updates`` +1,
  ``stack_rebuilds`` +0).

Bits, counts and bytes are discrete: exact agreement (tolerance 0)."""

import numpy as np
import pytest

from pilosa_tpu import api as japi
from pilosa_tpu.core.fragment import Fragment as JFragment
from pilosa_tpu.roaring import codec as jcodec
from pilosa_tpu_torch import api as tapi
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.roaring import codec

SW = 1 << 20
W64 = SW // 64


def _words(bits):
    return np.packbits(bits, bitorder="little").view("<u8").copy()


def _row(rng, kind):
    """One row's (words or None, positions or None) of a container mix."""
    if kind == "random":
        return rng.integers(0, 1 << 64, W64, dtype=np.uint64), None
    bits = np.zeros(SW, dtype=np.uint8)
    if kind == "runs":
        lo, hi = sorted(rng.integers(0, SW, 2).tolist())
        bits[lo:hi] = 1
        bits[rng.integers(0, SW, 50)] = 1
    elif kind == "few":  # a dense store row with array containers only
        bits[rng.integers(0, SW, 3000)] = 1
    elif kind == "mixed":  # one bitmap, one run and array containers
        bits[rng.integers(0, SW, 100)] = 1
        bits[3 << 16:4 << 16:2] = 1
        bits[5 << 16:(5 << 16) + 5000] = 1
    else:  # sparse
        return None, np.unique(rng.integers(0, SW, 200)).astype(np.uint32)
    return _words(bits), None


def _rows(seed, kinds):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(300, len(kinds), replace=False)).tolist()
    return [(r,) + _row(rng, k) for r, k in zip(ids, kinds)]


def _positions(rows):
    out = []
    for r, w, p in rows:
        if w is not None:
            p = np.flatnonzero(np.unpackbits(w.view(np.uint8), bitorder="little"))
        out.append(p.astype(np.uint64) + np.uint64(r * SW))
    return np.concatenate(out)


MIXES = {
    "dense": ["random"] * 4,
    "runs": ["runs", "random", "runs"],
    "few": ["few", "random"],
    "sparse_and_dense": ["sparse", "random", "sparse", "mixed", "sparse"],
    "mixed": ["mixed", "few", "runs", "sparse", "random", "mixed"],
}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [1, 2])
def test_serialize_rows_writes_the_reference_bytes(mix, seed):
    rows = _rows(seed, MIXES[mix])
    want = jcodec.serialize(_positions(rows))
    assert codec.serialize_rows(rows) == want


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_decode_rows_gives_the_reference_bits(mix):
    rows = _rows(7, MIXES[mix])
    data = jcodec.serialize(_positions(rows))
    dec = codec.decode_rows(data)
    assert dec is not None
    back = [dec.positions] + [
        np.flatnonzero(np.unpackbits(w.view(np.uint8), bitorder="little")).astype(np.uint64)
        + np.uint64(r * SW) for r, w in zip(dec.rows, dec.words)]
    want = jcodec.deserialize(data).values
    np.testing.assert_array_equal(np.sort(np.concatenate(back)), want)
    assert dec.bits() == want.size
    np.testing.assert_array_equal(dec.columns(), np.unique(want % np.uint64(SW)))
    # Rows of more than 4096 bits come back as words, the rest as
    # positions.
    wide = {r for r, w, _ in rows if w is not None and int(np.bitwise_count(w).sum()) > 4096}
    assert set(dec.rows) == wide


def test_decode_rows_declines_or_raises():
    rows = _rows(3, ["random", "sparse"])
    data = jcodec.serialize(_positions(rows))
    # An op-log tail: deserialize replays it.
    tail = data + jcodec.encode_op(jcodec.OP_TYPE_ADD, 5 * SW + 3)
    assert codec.decode_rows(tail) is None
    # Rows of few bits only (array containers, short runs, a bitmap
    # container of a foreign writer's), and the official format: nothing
    # to gain; a row store keeps such rows sparse.
    assert codec.decode_rows(jcodec.serialize(np.arange(0, 4000, 3, dtype=np.uint64))) is None
    runs = np.array([5, 6, 7, SW + 9, SW + 10, 3 * SW + 100], dtype=np.uint64)
    assert codec.decode_rows(jcodec.serialize(runs)) is None
    assert codec.decode_rows(jcodec.serialize(runs), dense_over=2).rows == [0]
    assert codec.decode_rows(bytes.fromhex("3a300000" "01000000" "0000" "0000" "10000000"
                                           "0500")) is None
    for bad in (data[:4], data[:20], data[:-8]):
        with pytest.raises(ValueError):
            jcodec.deserialize(bad)
        if len(bad) > 20:
            # A cut payload reads as a shorter body, which deserialize
            # refuses: decode_rows declines it to deserialize.
            assert codec.decode_rows(bad) is None
        else:
            with pytest.raises(ValueError):
                codec.decode_rows(bad)


def _frag_state(frag):
    return {r: (frag.row_count(r), frag.row_words(r).tobytes()) for r in frag.row_ids()}


@pytest.mark.parametrize("mix", ["dense", "mixed"])
def test_fragment_file_of_the_reference_opens_by_rows(tmp_path, mix):
    rows = _rows(11, MIXES[mix])
    data = jcodec.serialize(_positions(rows))
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jf = JFragment("i", "f", "standard", 0, path=jpath)
    jf.import_roaring(data)
    jf.close()
    tf = Fragment("i", "f", "standard", 0, path=jpath, device="cpu")
    jf = JFragment("i", "f", "standard", 0, path=jpath)
    assert tf.row_ids() == jf.row_ids()
    assert _frag_state(tf) == _frag_state(jf)
    # And the port's snapshot of those rows is the reference's file.
    tf2 = Fragment("i", "f", "standard", 0, path=tpath, device="cpu")
    tf2.import_roaring(data)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    for f in (tf, jf, tf2):
        f.close()


@pytest.mark.parametrize("clear", [False, True], ids=["union", "clear"])
def test_fragment_import_roaring_by_rows_matches_the_reference(tmp_path, clear):
    base = _rows(21, ["random", "sparse", "mixed", "few"])
    body = [(r, w, p) for r, w, p in _rows(22, ["random", "runs", "sparse"])]
    # Overlap the body's rows with the fragment's.
    body = [(base[i][0], w, p) for i, (_, w, p) in enumerate(body)]
    body.append((299, np.random.default_rng(23).integers(0, 1 << 64, W64, dtype=np.uint64),
                 None))
    body.sort(key=lambda t: t[0])
    paths = [str(tmp_path / n) for n in ("j", "t")]
    frags = [JFragment("i", "f", "standard", 0, path=paths[0]),
             Fragment("i", "f", "standard", 0, path=paths[1], device="cpu")]
    for f in frags:
        f.import_roaring(jcodec.serialize(_positions(base)))
    data = jcodec.serialize(_positions(body))
    assert codec.decode_rows(data) is not None
    changed = [f.import_roaring(data, clear=clear) for f in frags]
    assert changed[0] == changed[1] > 0
    assert _frag_state(frags[1]) == _frag_state(frags[0])
    assert open(paths[1], "rb").read() == open(paths[0], "rb").read()
    for f in frags:
        f.close()


@pytest.mark.parametrize("existence", [True, False], ids=["existence", "no_existence"])
def test_api_import_roaring_dense_syncs_in_place(existence):
    apis = japi.API(), tapi.API(device="cpu")
    rng = np.random.default_rng(31)
    first = jcodec.serialize(_positions([(r, rng.integers(0, 1 << 64, W64, dtype=np.uint64),
                                          None) for r in (2, 3, 4)]))
    for api in apis:
        api.create_index("d", track_existence=existence)
        api.create_field("d", "f")
        api.import_roaring("d", "f", 1, first)
    q = "Count(Intersect(Row(f=2), Row(f=3)))"
    eng = apis[1].engine
    eng.result_memo.maxsize = 0
    want = apis[0].query(japi.QueryRequest("d", q)).results
    assert apis[1].query(tapi.QueryRequest("d", q)).results == want
    upd, reb = eng.stack_updates, eng.stack_rebuilds
    bits = np.zeros(SW, dtype=np.uint8)
    bits[rng.integers(0, SW, 1 << 18)] = 1
    data = jcodec.serialize(_positions([(3, _words(bits), None)]))
    n = [api.import_roaring("d", "f", 1, data) for api in apis]
    assert n[0] == n[1] > 0
    assert apis[1].query(tapi.QueryRequest("d", q)).results == \
        apis[0].query(japi.QueryRequest("d", q)).results
    assert (eng.stack_updates - upd, eng.stack_rebuilds - reb) == (1, 0)
    for text in ("Count(Row(f=3))", "Row(f=3)", "TopN(f, n=3)") + (
            ("Count(Not(Row(f=2)))",) if existence else ()):
        got = apis[1].query(tapi.QueryRequest("d", text)).results
        want = apis[0].query(japi.QueryRequest("d", text)).results
        if text == "Row(f=3)":
            np.testing.assert_array_equal(got[0].columns(), want[0].columns())
        elif text.startswith("TopN"):
            assert [tuple(p) for p in got[0]] == [tuple(p) for p in want[0]]
        else:
            assert got == want
