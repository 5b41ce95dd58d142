"""The port's HTTP node (pilosa_tpu_torch.net) against the JAX package's
(pilosa_tpu.net) on the same requests.

- The wire formats: the same QueryResponse of every result type (Count,
  Row with attributes and keys, TopN pairs, ValCount, GroupCounts,
  RowIdentifiers, bool, nil, column attribute sets) encodes to the same
  bytes in both packages through ``response_to_json``,
  ``count_response_bytes`` and ``proto.encode_query_response``, and the
  protobuf import and query requests round-trip, and ``result_from_json``
  decodes each result as the reference does.
- The HTTP surface, side by side: the reference's
  ``serve(pilosa_tpu.api.API())`` and the port's
  ``serve(pilosa_tpu_torch.api.API(device="cpu"))`` on both backends get
  the same sequence (schema, JSON and protobuf imports, import-roaring,
  value imports, queries of every result type with keys, Options and
  columnAttrs, export, the internal routes and the error cases) and answer
  with the same status, content type and body.  The only difference
  allowed is the value of ``traceID``, which both must carry.
- Concurrent Counts through the port's reactor come back exact.
- ``?profile=1``, ``GET /debug/plans`` and ``GET /debug/sequences``
  answer as the reference's node over a ``MeshEngine`` does, once the
  plans' timings (and the reference's heat-recorder ``touches``) are set
  aside (``tests/test_torch_plans.py`` holds the plans field by field).
- Every route this port leaves out answers 501 naming its ROADMAP.md item.

Ids, counts, keys and bytes are discrete: exact agreement (tolerance 0)."""

import http.client
import json
import re
import threading

import numpy as np
import pytest

from pilosa_tpu import api as japi
from pilosa_tpu.core.row import Row as JRow
from pilosa_tpu.executor import executor as jex
from pilosa_tpu.net import proto as jproto
from pilosa_tpu.net import wire as jwire
from pilosa_tpu.net.server import serve as jserve
from pilosa_tpu.roaring import codec as jcodec
from pilosa_tpu_torch import api as tapi
from pilosa_tpu_torch.core.row import Row as TRow
from pilosa_tpu_torch.executor import executor as tex
from pilosa_tpu_torch.net import proto as tproto
from pilosa_tpu_torch.net import wire as twire

# The routes and API methods the port answered with 501 until the
# multi-process mesh was ported, with the ROADMAP.md item that ported them.
_MESH_ITEM = "Queue 1 item 15 part C (the multi-process mesh)"
_UNPORTED_ROUTES = [
    ("POST", "/internal/mesh/dispatch", _MESH_ITEM),
    ("POST", "/internal/mesh/ticket", _MESH_ITEM),
]
_UNPORTED_API = {"mesh_ticket": _MESH_ITEM, "mesh_collective_accept": _MESH_ITEM}
from pilosa_tpu_torch.net.server import serve as tserve

SW = 1 << 20
PB = "application/x-protobuf"


# -- the wire formats ----------------------------------------------------------

def _responses(mod, row_cls, **row_kw):
    """One QueryResponse per result type, built from the same values."""
    row = row_cls.from_columns([1, 5, SW + 3, 3 * SW + 7], **row_kw)
    row.attrs = {"color": "blue", "n": 3, "ok": True, "w": 1.5}
    keyed = row_cls.from_columns([2, 9], **row_kw)
    keyed.keys = ["alpha", "beta"]
    empty = row_cls.from_columns([], **row_kw)
    groups = [mod.GroupCount([mod.FieldRow("a", 1), mod.FieldRow("b", 0, "k")], 12),
              mod.GroupCount([mod.FieldRow("a", 2)], 0)]
    results = [
        [7],
        [row, keyed, empty],
        [[(10, 5), (3, 2)], [("x", 4)], []],
        [mod.ValCount(-12, 4), mod.ValCount(0, 0)],
        [groups],
        [mod.RowIdentifiers([1, 2, 9]), mod.RowIdentifiers([], ["p", "q"])],
        [True, False],
        [None],
        [3, [(1, 1)], True, None, row, mod.ValCount(5, 1)],
    ]
    out = [mod.QueryResponse(r) for r in results]
    with_attrs = mod.QueryResponse([row])
    with_attrs.column_attr_sets = [mod.ColumnAttrSet(1, {"x": 1}),
                                   mod.ColumnAttrSet(5, {"y": "z"}, key="c5")]
    out.append(with_attrs)
    return out


def test_wire_formats_encode_the_same_bytes():
    refs = _responses(jex, JRow)
    ports = _responses(tex, TRow, device="cpu")
    for want, got in zip(refs, ports):
        assert (json.dumps(twire.response_to_json(got))
                == json.dumps(jwire.response_to_json(want)))
        for tid in (None, "0123456789abcdef"):
            assert (twire.count_response_bytes(got, tid)
                    == jwire.count_response_bytes(want, tid))
        for err in ("", "boom"):
            assert (tproto.encode_query_response(got, err=err)
                    == jproto.encode_query_response(want, err=err))


def test_result_from_json_decodes_as_the_reference():
    """Each result's JSON decodes (result_from_json) to what the
    reference decodes it to, re-encoded byte for byte."""
    for resp in _responses(tex, TRow, device="cpu"):
        for doc in twire.response_to_json(resp)["results"]:
            for name in ("TopN", "Count"):
                got = twire.result_from_json(name, doc, device="cpu")
                want = jwire.result_from_json(name, doc)
                assert type(got).__name__ == type(want).__name__
                assert (json.dumps(twire.result_to_json(got))
                        == json.dumps(jwire.result_to_json(want)))


def test_count_fast_path_matches_the_general_walk():
    """The fast encoder and the generic walk give the same bytes wherever
    the fast one applies (ints and id pairs)."""
    for results in ([5], [0, 1 << 40], [[(3, 9), (1, 2)]], [4, [(7, 7)], []]):
        resp = tex.QueryResponse(results)
        out = twire.response_to_json(resp)
        out["traceID"] = "feedfacecafebeef"
        assert (twire.count_response_bytes(resp, "feedfacecafebeef")
                == json.dumps(out).encode())
    assert twire.count_response_bytes(tex.QueryResponse([True])) is None
    assert twire.count_response_bytes(tex.QueryResponse([[("k", 1)]])) is None


def test_proto_requests_round_trip():
    args = dict(row_ids=[1, 1, 7], column_ids=[3, SW + 4, 9], timestamps=[0, 10 ** 18, 5])
    for kw in (args, dict(row_keys=["a", "b"], column_keys=["x", "y"])):
        data = tproto.encode_import_request("i", "f", 2, **kw)
        assert data == jproto.encode_import_request("i", "f", 2, **kw)
        assert tproto.decode_import_request(data) == jproto.decode_import_request(data)
        doc = tproto.decode_import_request(data)
        assert (doc["index"], doc["field"], doc["shard"]) == ("i", "f", 2)
        assert doc["rowIDs"] == kw.get("row_ids", [])
        assert doc["columnKeys"] == kw.get("column_keys", [])
    data = tproto.encode_import_value_request("i", "v", 0, column_ids=[1, 2], values=[-3, 40])
    assert data == jproto.encode_import_value_request("i", "v", 0, column_ids=[1, 2],
                                                      values=[-3, 40])
    assert tproto.decode_import_value_request(data) == jproto.decode_import_value_request(data)
    q = tproto.encode_query_request("Count(Row(f=1))", shards=[0, 3], column_attrs=True)
    assert q == jproto.encode_query_request("Count(Row(f=1))", shards=[0, 3], column_attrs=True)
    doc = tproto.decode_query_request(q)
    assert doc == jproto.decode_query_request(q)
    assert doc["query"] == "Count(Row(f=1))" and doc["shards"] == [0, 3]
    for want, got in zip(_responses(jex, JRow), _responses(tex, TRow, device="cpu")):
        data = tproto.encode_query_response(got)
        back = tproto.decode_query_response(data, device="cpu")
        ref = jproto.decode_query_response(data)
        assert len(back["results"]) == len(ref["results"]) == len(got.results)
        assert tproto.encode_query_response(tex.QueryResponse(back["results"])) == \
            jproto.encode_query_response(jex.QueryResponse(ref["results"]))


# -- the HTTP surface, side by side --------------------------------------------

@pytest.fixture(params=["async", "threaded"])
def pair(request):
    """The reference node and the port's, on one backend."""
    ja, ta = japi.API(), tapi.API(device="cpu")
    js, _ = jserve(ja, "localhost", 0, backend=request.param)
    ts, _ = tserve(ta, "localhost", 0, backend=request.param)
    yield js.server_address[1], ts.server_address[1], ta
    for srv in (js, ts):
        srv.shutdown()
        srv.server_close()
    ja.holder.close()
    ta.close()


def send(port, method, path, body=b"", headers=None):
    conn = http.client.HTTPConnection("localhost", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _strip_trace(body: bytes):
    doc = json.loads(body)
    if isinstance(doc, dict) and "traceID" in doc:
        tid = doc.pop("traceID")
        assert isinstance(tid, str) and len(tid) == 16
        return doc, True
    return doc, False


def same(ports, method, path, body=b"", headers=None, status=200):
    """Send one request to both nodes: the same status, content type and
    body, with ``traceID`` carried by both or neither (its value aside).
    Returns the port's decoded body (JSON) or raw bytes."""
    jport, tport = ports[:2]
    if isinstance(body, str):
        body = body.encode()
    want = send(jport, method, path, body, headers)
    got = send(tport, method, path, body, headers)
    assert got[0] == want[0] == status, (path, body, want, got)
    assert got[1] == want[1], (path, want[1], got[1])
    if got[1] == "application/json":
        g, g_tid = _strip_trace(got[2])
        w, w_tid = _strip_trace(want[2])
        assert g == w, (path, body, w, g)
        assert g_tid == w_tid
        # Byte for byte once the trace id is set aside.
        assert json.dumps(g).encode() == json.dumps(w).encode()
        return g
    assert got[2] == want[2], (path, body, want[2], got[2])
    return got[2]


def q(ports, index, text, status=200, path_suffix="", headers=None):
    return same(ports, "POST", f"/index/{index}/query{path_suffix}", text, headers,
                status=status)


def _schema(ports):
    same(ports, "POST", "/index/i", "")
    same(ports, "POST", "/index/k", json.dumps({"options": {"keys": True}}))
    same(ports, "POST", "/index/i/field/f", "")
    same(ports, "POST", "/index/i/field/g", "")
    same(ports, "POST", "/index/i/field/v",
         json.dumps({"options": {"type": "int", "min": -10, "max": 1000}}))
    same(ports, "POST", "/index/i/field/t",
         json.dumps({"options": {"type": "time", "timeQuantum": "YMD"}}))
    same(ports, "POST", "/index/i/field/m", json.dumps({"options": {"type": "mutex"}}))
    same(ports, "POST", "/index/k/field/kf", json.dumps({"options": {"keys": True}}))
    same(ports, "POST", "/index/i/field/f", "", status=400)
    for path in ("/schema", "/index", "/index/i", "/index/k", "/info", "/version", "/",
                 "/status"):
        same(ports, "GET", path)
    same(ports, "GET", "/index/nope", status=404)


def _imports(ports):
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 6, 300).tolist()
    cols = (rng.integers(0, 3, 300) * SW + rng.integers(0, 4000, 300)).tolist()
    same(ports, "POST", "/index/i/field/f/import",
         json.dumps({"rowIDs": rows, "columnIDs": cols}))
    # The same bits again in protobuf into g, and a clear of some of them.
    body = tproto.encode_import_request("i", "g", 0, row_ids=rows, column_ids=cols)
    assert body == jproto.encode_import_request("i", "g", 0, row_ids=rows, column_ids=cols)
    same(ports, "POST", "/index/i/field/g/import", body, {"Content-Type": PB})
    clear = tproto.encode_import_request("i", "g", 0, row_ids=rows[:40], column_ids=cols[:40])
    same(ports, "POST", "/index/i/field/g/import?clear=true", clear, {"Content-Type": PB})
    # Timestamps (epoch nanoseconds) into the time field.
    ts = [1514764800 * 10 ** 9 + k * 86400 * 10 ** 9 for k in range(20)]
    same(ports, "POST", "/index/i/field/t/import",
         json.dumps({"rowIDs": [1] * 20, "columnIDs": list(range(20)), "timestamps": ts}))
    # BSI values, and a roaring bitmap of row 9 into f.
    vcols = sorted(set(cols))[:120]
    vals = rng.integers(-10, 1000, len(vcols)).tolist()
    same(ports, "POST", "/index/i/field/v/import",
         json.dumps({"columnIDs": vcols, "values": vals}))
    pos = np.unique(9 * SW + rng.integers(0, SW, 500)).astype(np.uint64)
    data = jcodec.serialize(pos)
    assert same(ports, "POST", "/index/i/field/f/import-roaring/1", data) == {"changed": 500}
    same(ports, "POST", "/index/i/field/f/import-roaring/1?clear=true",
         jcodec.serialize(pos[:100]))
    # Keyed rows and columns.
    same(ports, "POST", "/index/k/field/kf/import",
         json.dumps({"rowKeys": ["a", "b", "a", "c"], "columnKeys": ["x", "y", "z", "x"]}))
    same(ports, "POST", "/index/i/field/m/import",
         json.dumps({"rowIDs": [1, 2, 3], "columnIDs": [5, 5, 6]}))


QUERIES = [
    ("i", "Count(Row(f=1))"),
    ("i", "Count(Intersect(Row(f=1), Row(g=2)))"),
    ("i", "Count(Union(Row(f=1), Row(f=2))) Count(Difference(Row(f=3), Row(g=3)))"),
    ("i", "Row(f=2)"),
    ("i", "Xor(Row(f=1), Row(g=1))"),
    ("i", "TopN(f, n=3)"),
    ("i", "TopN(f, Row(g=4), n=2)"),
    ("i", "Sum(field=v)"),
    ("i", "Min(field=v) Max(field=v)"),
    ("i", "Sum(Row(f=1), field=v)"),
    ("i", "Count(Range(v > 100))"),
    ("i", "Range(t=1, 2018-01-02T00:00, 2018-01-09T00:00)"),
    ("i", "GroupBy(Rows(field=f), Rows(field=g))"),
    ("i", "Rows(field=f)"),
    ("i", "Rows(field=m)"),
    ("i", "Options(Count(Row(f=1)), shards=[0, 2])"),
    ("i", "Set(77, f=1) Clear(77, f=1) Count(Row(f=1))"),
    ("i", "SetRowAttrs(f, 2, color=\"red\", n=4)"),
    ("i", "SetColumnAttrs(5, seen=true)"),
    ("i", "Row(f=2)"),
    ("k", "Row(kf=\"a\")"),
    ("k", "TopN(kf, n=2)"),
    ("k", "Count(Row(kf=\"a\"))"),
    ("k", "Rows(field=kf)"),
    ("k", "GroupBy(Rows(field=kf))"),
    ("k", "Set(\"w\", kf=\"d\") Row(kf=\"d\")"),
]


def test_http_surface_matches_the_reference(pair):
    _schema(pair)
    _imports(pair)
    for index, text in QUERIES:
        q(pair, index, text)
        # A JSON body {"query": ...} and a JSON-quoted PQL body.
        q(pair, index, json.dumps({"query": text}))
    # Options of the response: columnAttrs, excludeColumns, excludeRowAttrs.
    q(pair, "i", "Row(f=2)", path_suffix="?columnAttrs=true")
    q(pair, "i", json.dumps({"query": "Row(f=2)", "excludeColumns": True}))
    q(pair, "i", "Row(f=2)", path_suffix="?excludeRowAttrs=true")
    q(pair, "i", "Count(Row(f=1))", path_suffix="?shards=0,1")
    # Protobuf queries: a protobuf request and response, a JSON request
    # with a protobuf response, a protobuf request with a JSON response.
    for text in ("Count(Row(f=1))", "Row(f=2) TopN(f, n=2) Sum(field=v)",
                 "GroupBy(Rows(field=f))"):
        body = tproto.encode_query_request(text)
        same(pair, "POST", "/index/i/query", body, {"Content-Type": PB, "Accept": PB})
        same(pair, "POST", "/index/i/query", json.dumps({"query": text}), {"Accept": PB})
        same(pair, "POST", "/index/i/query", body, {"Content-Type": PB})
    same(pair, "POST", "/index/k/query", tproto.encode_query_request("Row(kf=\"a\")"),
         {"Content-Type": PB, "Accept": PB})
    # Export, and the internal routes backup, restore and translation use.
    for shard in (0, 1, 2):
        same(pair, "GET", f"/export?index=i&field=f&shard={shard}")
    same(pair, "GET", "/export?index=k&field=kf&shard=0")
    same(pair, "GET", "/internal/shards/max")
    same(pair, "GET", "/internal/fragment/data?index=i&field=f&shard=1")
    same(pair, "POST", "/internal/translate/keys",
         json.dumps({"index": "k", "field": "kf", "keys": ["a", "q"]}))
    frag = send(pair[1], "GET", "/internal/fragment/data?index=i&field=g&shard=0")[2]
    same(pair, "POST", "/internal/fragment/data?index=i&field=f&shard=0", frag)
    q(pair, "i", "Count(Union(Row(f=1), Row(g=1)))")
    same(pair, "GET", "/readyz")
    # Deletes, then the schema again.
    same(pair, "DELETE", "/index/i/field/g")
    same(pair, "DELETE", "/index/k")
    same(pair, "GET", "/schema")


def test_http_errors_match_the_reference(pair):
    _schema(pair)
    q(pair, "nope", "Count(Row(f=1))", status=404)
    q(pair, "i", "Count(Row(f=1)", status=400)
    q(pair, "i", "Bogus(f=1)", status=400)
    q(pair, "i", "Row(nofield=1)", status=404)
    q(pair, "i", "Count(Row(f=1))", status=400, headers={"X-Pilosa-Replica-Read": "fast"})
    q(pair, "i", "Count(Row(f=1))", status=400, headers={"X-Pilosa-Freshness-Ms": "soon"})
    q(pair, "i", "Count(Row(f=1))", headers={"X-Pilosa-Replica-Read": "primary"})
    # A non-UTF-8 body under protobuf negotiation is a 400 with the error
    # in the protobuf response.
    same(pair, "POST", "/index/i/query", b"\xff\xfe\x00bad", {"Accept": PB}, status=400)
    same(pair, "POST", "/index/i/query", tproto.encode_query_request("Count(Row(f=1)"),
         {"Content-Type": PB, "Accept": PB}, status=400)
    same(pair, "POST", "/index/i/field/f/import",
         json.dumps({"rowKeys": ["a"], "columnIDs": [1]}), status=400)
    same(pair, "POST", "/index/nope/field/f/import",
         json.dumps({"rowIDs": [1], "columnIDs": [1]}), status=404)
    same(pair, "POST", "/index/i/field/f/import",
         tproto.encode_import_request("i", "f", 0, row_ids=[1], column_ids=[1],
                                      timestamps=[10 ** 18]),
         {"Content-Type": PB}, status=400)
    same(pair, "GET", "/export?index=i&field=f&shard=9", status=404)
    same(pair, "GET", "/nowhere", status=404)
    same(pair, "DELETE", "/index/nope", status=400)


def test_concurrent_counts_through_the_reactor(pair):
    """Counts from several threads on their own connections, deferred
    through the port's batcher on the reactor thread: every answer exact."""
    tport, ta = pair[1], pair[2]
    ta.create_index("c")
    ta.create_field("c", "f")
    rng = np.random.default_rng(3)
    cols = {r: np.unique(rng.integers(0, 3 * SW, 2000)) for r in range(8)}
    for r, cs in cols.items():
        ta.import_bits(tapi.ImportRequest("c", "f", row_ids=[r] * len(cs),
                                          column_ids=cs.tolist()))
    texts, want = [], []
    for a in range(8):
        for b in range(8):
            texts.append(f"Count(Intersect(Row(f={a}), Row(f={b})))")
            want.append(len(np.intersect1d(cols[a], cols[b])))
    errors = []

    def run(t):
        conn = http.client.HTTPConnection("localhost", tport, timeout=60)
        try:
            for k in range(t, len(texts), 8):
                conn.request("POST", "/index/c/query", body=texts[k])
                resp = conn.getresponse()
                doc = json.loads(resp.read())
                if resp.status != 200 or doc["results"] != [want[k]] or "traceID" not in doc:
                    errors.append((texts[k], resp.status, doc, want[k]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=run, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors[:3]


# -- /recalculate-caches and /debug/pprof* -------------------------------------

def test_recalculate_caches_matches_the_reference(pair):
    """After writes that change a ranked cache's order, TopN serves the
    debounced ranking on both nodes; POST /recalculate-caches re-ranks
    every fragment's cache, and TopN then answers as the reference's does,
    with the new order."""
    same(pair, "POST", "/index/r", "")
    same(pair, "POST", "/index/r/field/f", "")
    rows = [r for r in range(6) for _ in range(10 * (r + 1))]
    cols = [SW * (k % 3) + k for k in range(len(rows))]
    same(pair, "POST", "/index/r/field/f/import",
         json.dumps({"rowIDs": rows, "columnIDs": cols}))
    before = q(pair, "r", "TopN(f, n=3)")
    # Row 0 overtakes every other row: 70 more bits.
    sets = " ".join(f"Set({5000 + k}, f=0)" for k in range(70))
    q(pair, "r", sets)
    assert same(pair, "POST", "/recalculate-caches", "") == {}
    after = q(pair, "r", "TopN(f, n=3)")
    assert after != before and after["results"][0][0] == {"id": 0, "count": 80}


def test_api_recalculate_caches_matches_the_reference():
    """``API.recalculate_caches`` re-ranks the caches as the reference's
    does: TopN equal after a cache-changing write."""
    ja, ta = japi.API(), tapi.API(device="cpu")
    try:
        for a in (ja, ta):
            a.create_index("r").create_field("f")
            a.import_bits(japi.ImportRequest("r", "f", row_ids=[1] * 30 + [2] * 20,
                                             column_ids=list(range(50)))
                          if a is ja else tapi.ImportRequest(
                              "r", "f", row_ids=[1] * 30 + [2] * 20, column_ids=list(range(50))))
        ask = lambda a, text: a.query(  # noqa: E731
            (japi if a is ja else tapi).QueryRequest("r", text)).results
        assert ask(ta, "TopN(f, n=2)") == ask(ja, "TopN(f, n=2)")
        for a in (ja, ta):
            ask(a, " ".join(f"Set({100 + k}, f=2)" for k in range(25)))
            assert a.recalculate_caches() is None
        got = [tuple(p) for p in ask(ta, "TopN(f, n=2)")[0]]
        assert got == [tuple(p) for p in ask(ja, "TopN(f, n=2)")[0]] == [(2, 45), (1, 30)]
    finally:
        ja.holder.close()
        ta.close()


@pytest.mark.parametrize("route", ["/debug/pprof", "/debug/pprof/goroutine"])
def test_debug_pprof_thread_dump(pair, route):
    """/debug/pprof and /debug/pprof/goroutine: a stack dump of every
    thread, the serving thread among them, in the reference's shape."""
    jport, tport = pair[:2]
    want, got = send(jport, "GET", route), send(tport, "GET", route)
    assert got[0] == want[0] == 200 and got[1] == want[1] == "application/json"
    jdoc, tdoc = json.loads(want[2]), json.loads(got[2])
    assert set(tdoc) == set(jdoc) == {"threads", "count"}
    assert tdoc["count"] == len(tdoc["threads"]) >= 1
    assert all(isinstance(v, list) and v for v in tdoc["threads"].values())
    assert any("_debug_pprof" in "".join(v) for v in tdoc["threads"].values())


def test_debug_pprof_profile_and_heap(pair):
    """/debug/pprof/profile samples every thread into folded stacks (a
    busy thread shows up); /debug/pprof/heap arms tracemalloc, snapshots
    the top allocation sites, and ?reset=true stops it: the reference's
    fields on both nodes."""
    import tracemalloc

    jport, tport = pair[:2]
    stop = threading.Event()

    def spin():  # a busy thread the profiler must catch
        while not stop.is_set():
            sum(range(1000))

    t = threading.Thread(target=spin, daemon=True, name="busy-worker")
    t.start()
    try:
        docs = [json.loads(send(p, "GET", "/debug/pprof/profile?seconds=0.3&hz=200")[2])
                for p in (jport, tport)]
    finally:
        stop.set()
        t.join(10)
    jdoc, tdoc = docs
    assert set(tdoc) == set(jdoc)
    assert tdoc["samples"] > 10 and tdoc["seconds"] == 0.3 and tdoc["hz"] == 200
    assert any("spin" in line for line in tdoc["folded"])
    assert any("spin" in e["func"] for e in tdoc["top"])
    was = tracemalloc.is_tracing()
    try:
        for port in (jport, tport):
            send(port, "GET", "/debug/pprof/heap?reset=true")
            armed = json.loads(send(port, "GET", "/debug/pprof/heap")[2])
            assert armed["tracing"] is True and "note" in armed
            snap = json.loads(send(port, "GET", "/debug/pprof/heap")[2])
            assert set(snap) == {"tracing", "tracedBytes", "peakBytes", "top"}
            assert snap["peakBytes"] >= snap["tracedBytes"] > 0 and snap["top"]
            assert json.loads(send(port, "GET", "/debug/pprof/heap?reset=true")[2]) == {
                "tracing": False}
    finally:
        if was and not tracemalloc.is_tracing():
            tracemalloc.start(25)


def test_pprof_profile_serialized_and_capped():
    """Two profiles at once run one after the other (their windows never
    overlap); a third that cannot start within PPROF_WAIT_SECONDS gets a
    429; past PPROF_MAX_STACKS distinct stacks, samples aggregate under
    the overflow key (after tests/test_plans.py's reference test)."""
    from pilosa_tpu_torch.net.server import Handler

    a = tapi.API(device="cpu")
    handler = Handler(a)
    results = []

    def run(seconds="0.2"):
        results.append(handler._debug_pprof_profile({"seconds": [seconds], "hz": ["200"]}, b""))

    try:
        threads = [threading.Thread(target=run) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        first, second = sorted(results, key=lambda r: r["startedMonotonic"])
        assert second["startedMonotonic"] >= first["endedMonotonic"]
        assert all(r["samples"] > 0 and r["distinctStacks"] <= r["maxStacks"] for r in results)
        old_cap, old_wait = Handler.PPROF_MAX_STACKS, Handler.PPROF_WAIT_SECONDS
        try:
            Handler.PPROF_MAX_STACKS = 1
            stop = threading.Event()

            def spin_a():
                while not stop.is_set():
                    sum(range(500))

            def spin_b():
                while not stop.is_set():
                    sum(range(600))

            busy = [threading.Thread(target=f, daemon=True) for f in (spin_a, spin_b)]
            for t in busy:
                t.start()
            try:
                doc = handler._debug_pprof_profile({"seconds": ["0.2"], "hz": ["200"]}, b"")
            finally:
                stop.set()
                for t in busy:
                    t.join(10)
            assert doc["distinctStacks"] == 2 and doc["truncatedSamples"] > 0
            assert any(line.startswith("<overflow> ") for line in doc["folded"])
            Handler.PPROF_WAIT_SECONDS = 0.05
            with Handler._pprof_profile_lock:
                status, ctype, body = handler._debug_pprof_profile({"seconds": ["0.1"]}, b"")
            assert status == 429 and ctype == "application/json"
            assert json.loads(body)["retryAfterSeconds"] == 0.05
        finally:
            Handler.PPROF_MAX_STACKS, Handler.PPROF_WAIT_SECONDS = old_cap, old_wait
    finally:
        a.close()


def test_pprof_trace_captures_a_chrome_trace(pair, tmp_path):
    """POST /debug/pprof/trace: a torch.profiler capture of the CPU
    activity (on the CPU node), written as a Chrome trace whose path the
    answer names, the Counts served meanwhile in it; ?seconds is capped at
    10; a capture while one runs is refused as the reference refuses it."""
    from pilosa_tpu.net.server import Handler as JHandler
    from pilosa_tpu_torch.net.server import Handler as THandler

    jport, tport, ta = pair
    same(pair, "POST", "/index/i", "")
    same(pair, "POST", "/index/i/field/f", "")
    same(pair, "POST", "/index/i/field/f/import",
         json.dumps({"rowIDs": [1, 1, 2], "columnIDs": [1, 2, SW + 2]}))
    ta.engine.result_memo.maxsize = 0  # every Count computes
    stop = threading.Event()

    def counts():
        while not stop.is_set():
            send(tport, "POST", "/index/i/query", b"Count(Intersect(Row(f=1), Row(f=2)))")

    t = threading.Thread(target=counts, daemon=True)
    t.start()
    try:
        status, ctype, body = send(tport, "POST", f"/debug/pprof/trace?seconds=0.5&dir={tmp_path}")
    finally:
        stop.set()
        t.join(30)
    assert status == 200 and ctype == "application/json"
    doc = json.loads(body)
    assert doc["traceDir"] == str(tmp_path) and doc["seconds"] == 0.5
    with open(doc["traceFile"]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert "aten::bitwise_and" in names  # the Counts' plain evaluation, on serving threads
    # A capture already running: both nodes refuse the second alike.
    with JHandler._pprof_trace_lock, THandler._pprof_trace_lock:
        same(pair, "POST", "/debug/pprof/trace?seconds=0.1", status=400)


def test_debug_vars_carries_engine_caches(pair):
    """/debug/vars' engineCaches carries the per-cache tallies under the
    reference's names and the sparse path's skipped bytes, after
    tests/test_sparsity.py's test of the reference."""
    from pilosa_tpu.util.stats import ENGINE_CACHES as J_CACHES

    tport = pair[1]
    send(tport, "POST", "/index/i", b"")
    send(tport, "POST", "/index/i/field/f", b"")
    send(tport, "POST", "/index/i/field/f/import",
         json.dumps({"rowIDs": [10, 10], "columnIDs": [1, 5]}).encode())
    send(tport, "POST", "/index/i/query", b"Count(Intersect(Row(f=10), Row(f=10)))")
    doc = json.loads(send(tport, "GET", "/debug/vars")[2])
    caches = doc["engineCaches"]["caches"]
    assert list(caches) == list(J_CACHES)
    assert caches["canonical"]["misses"] >= 1 and caches["result_memo"]["misses"] >= 1
    assert "deviceBytesSkipped" in doc["engineCaches"]
    assert "sparseDispatches" in doc["engineCaches"]
    text = send(tport, "GET", "/metrics")[2].decode()
    for series in ('pilosa_engine_cache_hits_total{cache="stack"}',
                   'pilosa_engine_cache_misses_total{cache="result_memo"}',
                   "pilosa_device_bytes_skipped_total"):
        assert series in text, series


@pytest.mark.parametrize("method,pattern,item", _UNPORTED_ROUTES)
def test_unported_routes_answer_501(method, pattern, item):
    """The multi-process mesh's routes, 501 until it was ported, answer as
    the reference's over an engine: the ticket route issues 0 then 1, and
    a dispatch with no kind is a 400 naming the unknown kind (the two-phase
    handoff itself: tests/test_torch_multihost.py)."""
    from pilosa_tpu.core.holder import Holder as JHolder
    from pilosa_tpu.parallel import MeshEngine, make_mesh

    jh = JHolder()
    jh.open()
    apis = [tapi.API(device="cpu"), japi.API(holder=jh, mesh_engine=MeshEngine(jh, make_mesh(1)))]
    servers = [tserve(apis[0], "localhost", 0)[0], jserve(apis[1], "localhost", 0)[0]]
    try:
        got = []
        for srv in servers:
            got.append([send(srv.server_address[1], method, pattern, b"{}") for _ in range(2)])
        assert got[0] == got[1], got
        status, ctype, body = got[0][1]
        assert ctype == "application/json"
        if pattern.endswith("ticket"):
            assert status == 200 and json.loads(body) == {"seq": 1}
        else:
            assert status == 400 and "unknown collective kind" in json.loads(body)["error"]
    finally:
        for srv in servers:
            srv.shutdown()
        apis[0].close()


def test_unported_options_answer_501():
    """A remote replay and a remote import, 501 before the cluster was
    ported, now answer 200 as the reference's do (the cluster's
    differentials are tests/test_torch_cluster*.py); a query plan
    (?profile=1) answers 200 with its plan (its differential is
    ``test_profile_answers_as_the_reference``), and the OpenMetrics
    exposition answers 200 (its differential is
    ``test_openmetrics_exemplars_as_the_reference``)."""
    a = tapi.API(device="cpu")
    a.create_index("i")
    a.create_field("i", "f")
    srv, _ = tserve(a, "localhost", 0)
    port = srv.server_address[1]
    try:
        status, _, out = send(port, "POST", "/index/i/query?profile=1", b"Count(Row(f=1))")
        assert status == 200 and json.loads(out)["plan"]["ops"][0]["path"] == "fast_cardinality"
        status, _, out = send(port, "POST", "/index/i/field/f/import?remote=true",
                              b'{"rowIDs": [1], "columnIDs": [1]}')
        assert status == 200 and json.loads(out) == {}, out
        status, _, out = send(port, "POST", "/index/i/query?remote=true", b"Count(Row(f=1))")
        assert status == 200 and json.loads(out)["results"] == [1], out
        status, ctype, out = send(port, "GET", "/metrics", b"",
                                  {"Accept": "application/openmetrics-text"})
        assert status == 200 and ctype.startswith("application/openmetrics-text")
        status, ctype, out = send(port, "GET", "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert b"pilosa_server_requests_total" in out
    finally:
        srv.shutdown()
        a.close()


def _engine_nodes(backend="async"):
    """The reference node over a MeshEngine on one mesh device (its plans
    name the engine's paths) and the port's, with the same seeded index."""
    from pilosa_tpu.core.holder import Holder as JHolder
    from pilosa_tpu.parallel import MeshEngine, make_mesh

    jh = JHolder()
    jh.open()
    ja = japi.API(holder=jh, mesh_engine=MeshEngine(jh, make_mesh(1)))
    ta = tapi.API(device="cpu")
    rng = np.random.default_rng(3)
    cols = rng.choice(3 * SW, 30000, replace=False)
    rows = rng.integers(0, 4, len(cols))
    for a in (ja, ta):
        a.create_index("i").create_field("f").import_bulk(rows.tolist(), cols.tolist())
    js, _ = jserve(ja, "localhost", 0, backend=backend)
    ts, _ = tserve(ta, "localhost", 0, backend=backend)
    return (ja, ta), (js, ts)


def _close_nodes(apis, servers):
    for srv in servers:
        srv.shutdown()
        srv.server_close()
    apis[1].close()


# Timings, and what is derived from them: the slow-plan retention ("slow",
# plans past 100 ms) and the queue-wait note.
_TIMING = ("startTime", "durationMs", "deviceSeconds", "stagesMs", "traceID", "seconds",
           "avgGapMs", "slow")


def _untimed(doc):
    if isinstance(doc, dict):
        return {k: _untimed(v) for k, v in doc.items() if k not in _TIMING}
    if isinstance(doc, list):
        return [_untimed(v) for v in doc
                if not (isinstance(v, str) and v.startswith("queue wait dominated"))]
    return doc


@pytest.mark.parametrize("backend", ["async", "threaded"])
def test_profile_answers_as_the_reference(backend):
    """POST ?profile=1 (and a JSON body's "profile") answers with the
    reference's status, results and plan, timings aside."""
    from pilosa_tpu.util import plans as jplans
    from pilosa_tpu_torch.util import plans as tplans

    apis, servers = _engine_nodes(backend)
    ports = [s.server_address[1] for s in servers]
    try:
        for mod in (jplans, tplans):
            mod.STORE.reset()
        for path, body, headers in (
                ("/index/i/query?profile=1", b"Count(Intersect(Row(f=1), Row(f=2)))", {}),
                ("/index/i/query?profile=true", b"Count(Union(Row(f=0), Row(f=3)))",
                 {"X-Pilosa-Tenant": "acme"}),
                ("/index/i/query", json.dumps({"query": "Count(Row(f=2)) TopN(f, n=2)",
                                               "profile": True}).encode(), {}),
                ("/index/i/query?profile=1", b"Count(Intersect(Row(f=1), Row(f=2)))", {})):
            got = [send(p, "POST", path, body, headers) for p in ports]
            assert got[0][:2] == got[1][:2] == (200, "application/json")
            docs = [json.loads(g[2]) for g in got]
            assert all(d["plan"]["traceID"] == d["traceID"] for d in docs)
            assert _untimed(docs[1]) == _untimed(docs[0])
        assert docs[1]["plan"]["ops"] == [{"op": "Count", "path": "memo", "memo": "hit"}]
    finally:
        _close_nodes(apis, servers)


@pytest.mark.parametrize("route", ["/debug/plans", "/debug/sequences"])
def test_plan_routes_answer_as_the_reference(route):
    """The two routes the query plans serve answer as the reference's."""
    from pilosa_tpu.util import plan_miner as jminer
    from pilosa_tpu.util import plans as jplans
    from pilosa_tpu_torch.util import plan_miner as tminer
    from pilosa_tpu_torch.util import plans as tplans

    apis, servers = _engine_nodes()
    ports = [s.server_address[1] for s in servers]
    try:
        for mod in (jplans, tplans):
            mod.STORE.reset()
        for mod in (jminer, tminer):
            mod.MINER.reset()
        for port in ports:
            for body in (b"Count(Intersect(Row(f=1), Row(f=2)))", b"Count(Row(f=1))",
                         b"Count(Union(Row(f=0), Row(f=3)))",
                         b"Count(Intersect(Row(f=1), Row(f=2)))"):
                assert send(port, "POST", "/index/i/query", body)[0] == 200
        for query in ("", "?limit=2", "?op=Count", "?top=1"):
            got = [send(p, "GET", route + query) for p in ports]
            assert got[0][:2] == got[1][:2] == (200, "application/json")
            docs = [_untimed(json.loads(g[2])) for g in got]
            assert docs[1] == docs[0], (route, query)
        assert docs[1] != {}
    finally:
        _close_nodes(apis, servers)


_EXEMPLAR = re.compile(r'^(\S+) (\d+) # \{trace_id="([0-9a-f]+)"\} (\S+) (\S+)$')


@pytest.mark.parametrize("backend", ["async", "threaded"])
def test_openmetrics_exemplars_as_the_reference(backend):
    """``Accept: application/openmetrics-text`` answers the OpenMetrics
    exposition as the reference does: its content type, exemplars of the
    shape ``# {trace_id="..."} value timestamp``, the answers' traceIDs
    among them on the pilosa_query_seconds buckets of the same label sets,
    counter families named without ``_total``, and ``# EOF`` last; the
    classic exposition carries no exemplar."""
    apis, servers = _engine_nodes(backend)
    ports = [s.server_address[1] for s in servers]
    try:
        shapes = []
        for port in ports:
            traces = set()
            for body in (b"Count(Intersect(Row(f=1), Row(f=2)))", b"Count(Union(Row(f=0), Row(f=3)))",
                         b"TopN(f, n=2)"):
                status, _, out = send(port, "POST", "/index/i/query", body)
                assert status == 200
                traces.add(json.loads(out)["traceID"])
            status, ctype, out = send(port, "GET", "/metrics", b"",
                                      {"Accept": "application/openmetrics-text"})
            assert status == 200
            lines = out.decode().splitlines()
            assert lines[-1] == "# EOF"
            series = set()
            for line in lines:
                m = _EXEMPLAR.match(line)
                if m is None:
                    assert ' # {trace_id="' not in line, line
                    continue
                float(m.group(4)), float(m.group(5))
                # The registry is process-wide: only this case's queries.
                if m.group(1).startswith("pilosa_query_seconds_bucket") and m.group(3) in traces:
                    series.add(m.group(1).split(",le=")[0])
            assert series
            assert "# TYPE pilosa_server_errors counter" in lines
            classic = send(port, "GET", "/metrics")[2].decode()
            assert "trace_id" not in classic and "# EOF" not in classic
            shapes.append((ctype, series))
        assert shapes[1] == shapes[0]
    finally:
        _close_nodes(apis, servers)


@pytest.mark.parametrize("name,item", sorted(_UNPORTED_API.items()))
def test_unported_api_methods_raise_naming_their_item(name, item):
    """The mesh's API methods, which raised until the multi-process mesh
    was ported, answer as the reference's: the sequencer's tickets count
    from 0, and a dispatch with no kind is refused naming it."""
    a = tapi.API(device="cpu")
    try:
        if name == "mesh_ticket":
            assert [a.mesh_ticket() for _ in range(3)] == [0, 1, 2]
        else:
            with pytest.raises(tapi.ApiError, match="unknown collective kind"):
                getattr(a, name)({})
    finally:
        a.close()
