"""Continuous queries in the port (pilosa_tpu_torch.net.cq, ``API.cq`` and
the ``/cq`` routes of net/server.py) against the JAX package's, on the
same writes.

- ``API.cq``: the ``seq`` of every delivery, its ``deltas`` (full results
  for a Count, added/removed ``diff`` lists for a ``Row``), no delivery
  for a write that leaves the result alone, ``resync`` with the full
  result once a reader's ``since`` has fallen off the trimmed log, and a
  KeyError after delete, equal to the reference's ``CQManager``.
- The routes: ``POST /cq``, ``GET /cq/{id}?since=&wait_ms=`` and
  ``DELETE /cq/{id}`` answer the reference's node with the same status,
  content type and body, a 404 after delete and a 400 without a query;
  ``/debug/vars`` and the flight recorder carry ``continuousQueries``.
- Process mode: the same create, long-poll and delete through a node with
  two worker processes, where a ``/cq`` request reaches the device owner
  as a passthrough frame; while one poll waits, a Count is answered.

Every ``wait_ms`` is short, and each wait that a write ends is capped at 5
s.  Ids, counts and sequence numbers are discrete: exact agreement
(tolerance 0)."""

import collections
import json
import threading
import time

import pytest

from pilosa_tpu import api as japi
from pilosa_tpu.net.server import serve as jserve
from pilosa_tpu_torch import api as tapi
from pilosa_tpu_torch.net.server import serve as tserve

from test_torch_http import same, send

SW = 1 << 20


def _apis():
    return japi.API(), tapi.API(device="cpu")


def _stream(api):
    """Writes and polls on one API: a Count tree and a Row subscription."""
    idx = api.create_index("c")
    idx.create_field("f")
    ex = api.executor
    ex.execute("c", f"Set(1, f=10) Set(2, f=10) Set(1, f=11) Set({SW + 4}, f=10)")
    out = []
    # The deltas counter is process-wide: count this stream's from here.
    d0 = api.cq.snapshot()["deltas"]

    def snapshot():
        return dict(api.cq.snapshot(), deltas=api.cq.snapshot()["deltas"] - d0)

    cnt = api.cq.create("c", "Count(Intersect(Row(f=10), Row(f=11)))")
    row = api.cq.create("c", "Row(f=10)")
    out += [cnt, row]
    try:
        assert api.cq.poll(cnt["id"], since=1, wait_ms=10)["deltas"] == []
        ex.execute("c", "Set(2, f=11)")
        a = api.cq.poll(cnt["id"], since=1, wait_ms=5000)
        b = api.cq.poll(row["id"], since=1, wait_ms=200)
        out += [a, b]
        ex.execute("c", f"Set(7, f=10) Set({SW + 9}, f=10)")
        out.append(api.cq.poll(row["id"], since=b["seq"], wait_ms=5000))
        ex.execute("c", "Clear(1, f=10)")
        out.append(api.cq.poll(row["id"], since=out[-1]["seq"], wait_ms=5000))
        out.append(api.cq.poll(cnt["id"], since=a["seq"], wait_ms=5000))
        ex.execute("c", "Set(9, f=12)")  # neither result moves
        out.append(api.cq.poll(cnt["id"], since=out[-1]["seq"], wait_ms=200))
        out.append(snapshot())
        out.append(api.cq.delete(row["id"]))
        with pytest.raises(KeyError):
            api.cq.poll(row["id"], since=0, wait_ms=0)
        with pytest.raises(KeyError):
            api.cq.delete(row["id"])
        out.append(snapshot())
    finally:
        api.cq.close()
    return out


def test_api_cq_as_the_reference():
    ja, ta = _apis()
    try:
        want, got = _stream(ja), _stream(ta)
    finally:
        ta.close()
    assert got == want
    # A write to another row leaves the Row subscription alone; then it
    # ships diffs of the changed ids, never the whole row.
    assert got[3]["deltas"] == []
    assert got[4]["deltas"][-1]["diff"] == [{"added": [7, SW + 9], "removed": []}]
    assert got[5]["deltas"][-1]["diff"] == [{"added": [], "removed": [1]}]
    assert got[7]["deltas"] == []
    assert got[8]["deltas"] == 4 and got[8]["active"] == 2
    # The Count's re-execution after each write was a repair.
    assert ta.engine.repairs.repaired["count"] >= 1


def _resync(api):
    api.create_index("r").create_field("f")
    api.executor.execute("r", "Set(1, f=10)")
    qid = api.cq.create("r", "Row(f=10)")["id"]
    try:
        sub = api.cq._subs[qid]
        sub.log = collections.deque(sub.log, maxlen=2)
        seq, seqs = 1, []
        for k in (20, 21, 22, 23):
            api.executor.execute("r", f"Set({k}, f=10)")
            seq = api.cq.poll(qid, since=seq, wait_ms=5000)["seq"]
            seqs.append(seq)
        # since=1 fell off the trimmed log and the survivors are diffs:
        # the poll answers with the current full result, marked resync.
        gap = api.cq.poll(qid, since=1, wait_ms=100)
        inside = api.cq.poll(qid, since=seq - 1, wait_ms=100)
    finally:
        api.cq.close()
    return seqs, gap, inside


def test_cq_resync_past_trimmed_log_as_the_reference():
    ja, ta = _apis()
    try:
        want, got = _resync(ja), _resync(ta)
    finally:
        ta.close()
    assert got == want
    seqs, gap, inside = got
    assert seqs == [2, 3, 4, 5]
    assert len(gap["deltas"]) == 1 and gap["deltas"][0]["resync"] is True
    assert gap["deltas"][0]["result"][0]["columns"] == [1, 20, 21, 22, 23]
    assert inside["deltas"] == [{"seq": 5, "diff": [{"added": [23], "removed": []}]}]


@pytest.fixture
def pair():
    ja, ta = _apis()
    js, _ = jserve(ja, "localhost", 0)
    ts, _ = tserve(ta, "localhost", 0)
    ports = (js.server_address[1], ts.server_address[1])
    same(ports, "POST", "/index/c", b"{}")
    same(ports, "POST", "/index/c/field/f", b"{}")
    same(ports, "POST", "/index/c/query", f"Set(1, f=10) Set(2, f=10) Set({SW}, f=11)")
    yield ports, ta
    for srv in (js, ts):
        srv.shutdown()
        srv.server_close()
    ja.holder.close()
    ta.close()


def test_cq_routes_as_the_reference(pair):
    ports, ta = pair
    doc = same(ports, "POST", "/cq",
               json.dumps({"index": "c", "query": "Count(Union(Row(f=10), Row(f=11)))"}))
    assert doc == {"id": "cq-1", "seq": 1, "result": [3]}
    row = same(ports, "POST", "/cq", json.dumps({"index": "c", "query": "Row(f=10)"}))
    assert row["id"] == "cq-2"
    assert same(ports, "GET", "/cq/cq-1?since=1&wait_ms=10")["deltas"] == []
    same(ports, "POST", "/index/c/query", "Set(5, f=10)")
    got = same(ports, "GET", "/cq/cq-1?since=1&wait_ms=5000")
    assert got == {"id": "cq-1", "seq": 2, "deltas": [{"seq": 2, "result": [4]}]}
    assert got["deltas"][-1]["result"] == same(ports, "POST", "/index/c/query",
                                               "Count(Union(Row(f=10), Row(f=11)))")["results"]
    assert ta.engine.repairs.repaired["count"] >= 1
    diff = same(ports, "GET", "/cq/cq-2?since=1&wait_ms=5000")
    assert diff["deltas"] == [{"seq": 2, "diff": [{"added": [5], "removed": []}]}]
    vars_ = json.loads(send(ports[1], "GET", "/debug/vars")[2])
    assert vars_["continuousQueries"]["active"] == 2
    assert "resultRepair" in vars_["engineCaches"]
    assert same(ports, "DELETE", "/cq/cq-1") == {"deleted": "cq-1"}
    same(ports, "GET", "/cq/cq-1?since=0", status=404)
    same(ports, "DELETE", "/cq/cq-1", status=404)
    same(ports, "POST", "/cq", json.dumps({"index": "c"}), status=400)


def test_flight_bundle_carries_continuous_queries():
    from pilosa_tpu_torch.util.history import HistorySampler
    from pilosa_tpu_torch.util.slo import SLOWatcher

    ta = tapi.API(device="cpu")
    try:
        ta.create_index("c").create_field("f")
        ta.cq.create("c", "Row(f=1)")
        hs = HistorySampler(ta, interval=1.0)
        bundle = SLOWatcher(ta, hs, error_rate_target=0.01).flight_bundle(now=1.7e9)
        assert bundle["continuousQueries"]["active"] == 1
        assert bundle["continuousQueries"]["subscriptions"][0]["query"] == "Row(f=1)"
    finally:
        ta.close()


def test_cq_through_process_mode():
    """``/cq`` through a node with two worker processes: a request that a
    worker accepts reaches the owner as a passthrough frame (counted on
    the owner), the long-poll blocks an owner pool thread while a Count
    through the other acceptors is answered, and delete then poll is a
    404."""
    ta = tapi.API(device="cpu")
    ts, _ = tserve(ta, "localhost", 0, workers=2)
    try:
        assert ts.wait_ready(60)
        port = ts.server_address[1]
        passed = {"n": 0}
        real = ts._handle_http

        def counting(conn, doc):
            if doc["target"].startswith("/cq"):
                passed["n"] += 1
            return real(conn, doc)

        ts._handle_http = counting
        assert send(port, "POST", "/index/c", b"{}")[0] == 200
        assert send(port, "POST", "/index/c/field/f", b"{}")[0] == 200
        send(port, "POST", "/index/c/query", b"Set(1, f=10) Set(2, f=10)")
        st, _, body = send(port, "POST", "/cq", json.dumps(
            {"index": "c", "query": "Count(Row(f=10))"}).encode())
        assert st == 200 and json.loads(body) == {"id": "cq-1", "seq": 1, "result": [2]}
        for _ in range(60):  # fresh connections until a worker took one
            assert send(port, "GET", "/cq/cq-1?since=1")[0] == 200
            if passed["n"]:
                break
        assert passed["n"] >= 1
        polled = {}

        def poll():
            polled["r"] = send(port, "GET", "/cq/cq-1?since=1&wait_ms=5000")

        t = threading.Thread(target=poll)
        t.start()
        time.sleep(0.2)
        for _ in range(6):  # answered while the poll waits
            st, _, body = send(port, "POST", "/index/c/query", b"Count(Row(f=10))")
            assert st == 200 and json.loads(body)["results"] == [2]
        assert t.is_alive()
        send(port, "POST", "/index/c/query", b"Set(3, f=10)")
        t.join(10)
        assert not t.is_alive()
        st, _, body = polled["r"]
        assert st == 200
        assert json.loads(body)["deltas"] == [{"seq": 2, "result": [3]}]
        assert send(port, "DELETE", "/cq/cq-1")[0] == 200
        assert send(port, "GET", "/cq/cq-1?since=0")[0] == 404
    finally:
        ts.shutdown()
        ts.server_close()
        ta.close()
