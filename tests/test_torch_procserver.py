"""The port's process mode (pilosa_tpu_torch.net.ipc, .worker, .procserver)
against the JAX package's frames and in-process node, and the executor's
Count lane through the batcher.

- ``ipc``: seeded HELLO, QUERY, HTTP, RESPONSE, RESULT_FAST and STATS
  frames are byte-identical to the reference's encoder, and each package
  decodes the other's.
- ``util.stats.merge_expositions`` gives the reference's text.
- A port ``ProcessHTTPServer`` with two worker processes answers the
  reference's in-process ``serve()`` with the same status, content type
  and body (``traceID`` aside): the schema, the imports, a query of every
  result type, repeats of Count queries, and the metrics of every
  process summed into one exposition.
- Admission is global: with the device owner's controller full, requests
  through any acceptor are shed and charged to their tenant.
- Cross-worker coalescing: two worker links (the real frame protocol on
  the owner's AF_UNIX socket) each send a Count while the batcher's
  workers are held; after the release one batch holds both, and
  ``cross_worker_fused_batches`` counts it.  No timing is asserted.
- The executor's synchronous Count lane goes through the batcher: two
  Counts queued while the workers are held ride one K5 batch; a lone
  Count runs directly.
- SIGKILL of a worker: /readyz turns 503, the supervisor respawns it and
  /readyz turns 200, and the answers stay exact.
- A worker's imports load neither torch nor the API, and a worker that
  served the whole sequence has not loaded torch.

Every wait has a limit, and the node runs two workers.  Frames, ids,
counts and bodies are discrete: exact agreement (tolerance 0)."""

import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from pilosa_tpu import api as japi
from pilosa_tpu.net import ipc as jipc
from pilosa_tpu.net.server import serve as jserve
from pilosa_tpu.util import stats as jstats
from pilosa_tpu_torch import api as tapi
from pilosa_tpu_torch.net import ipc as tipc
from pilosa_tpu_torch.net.admission import AdmissionController
from pilosa_tpu_torch.net.server import serve as tserve
from pilosa_tpu_torch.parallel.batcher import CountBatcher
from pilosa_tpu_torch.util import plans as tplans
from pilosa_tpu_torch.util import stats as tstats

from test_torch_http import QUERIES, _imports, _schema, q, same, send

SW = 1 << 20


# -- the frames ---------------------------------------------------------------------


def _frames(mod, rng):
    """One of each frame kind from the seeded generator."""
    shards = sorted(rng.choice(1 << 20, 5, replace=False).tolist())
    pairs = [(int(i), int(c)) for i, c in rng.integers(0, 1 << 40, (4, 2))]
    return [
        (mod.HELLO, mod.pack_hello(int(rng.integers(0, 64)), int(rng.integers(1, 1 << 22)))),
        (mod.QUERY, mod.pack_query(int(rng.integers(1, 1 << 62)), mod.F_PROFILE, "idx",
                                   "Count(Row(f=1))", "acme", "0123456789abcdef", None, shards)),
        (mod.QUERY, mod.pack_query(7, mod.F_COLUMN_ATTRS | mod.F_EXCL_COLUMNS, "i", "Row(f=2)",
                                   "default", None, "fedcba9876543210", None)),
        (mod.HTTP, mod.pack_http(int(rng.integers(1, 1 << 62)), "POST",
                                 "/index/i/field/f/import?clear=true",
                                 json.dumps({"Content-Type": "x"}).encode(),
                                 rng.bytes(int(rng.integers(0, 300))))),
        (mod.RESPONSE, mod.pack_response(3, 404, "application/json", b'{"error": "x"}')),
        (mod.RESULT_FAST, mod.pack_result_fast(9, "0011223344556677",
                                               [int(rng.integers(0, 1 << 50)), pairs, [], -5])),
        (mod.RESULT_FAST, mod.pack_result_fast(10, None, [])),
        (mod.STATS, mod.pack_stats(11, int(rng.integers(0, 1 << 40)), b"a_total 3\n")),
    ]


_UNPACK = {"QUERY": "unpack_query", "HTTP": "unpack_http", "RESPONSE": "unpack_response",
           "RESULT_FAST": "unpack_result_fast", "STATS": "unpack_stats"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ipc_frames_are_the_reference_bytes(seed):
    want = _frames(jipc, np.random.default_rng(seed))
    got = _frames(tipc, np.random.default_rng(seed))
    assert got == want
    for (ftype, payload) in got:
        name = next(k for k in ("HELLO",) + tuple(_UNPACK) if getattr(tipc, k) == ftype)
        if name == "HELLO":
            ct, cj = tipc.Cursor(payload), jipc.Cursor(payload)
            assert (ct.u32(), ct.u32()) == (cj.u32(), cj.u32())
            continue
        # Each package decodes the other's bytes as it decodes its own.
        mine = getattr(tipc, _UNPACK[name])(tipc.Cursor(payload))
        theirs = getattr(jipc, _UNPACK[name])(jipc.Cursor(payload))
        assert mine == theirs


def test_ipc_frames_cross_the_socket_both_ways():
    """A frame sent by one package's sender is read by the other's reader."""
    for send_mod, read_mod in ((tipc, jipc), (jipc, tipc)):
        a, b = socket.socketpair()
        try:
            sender = send_mod.FrameSender(a)
            frames = _frames(send_mod, np.random.default_rng(5))
            for ftype, payload in frames:
                sender.send(ftype, payload)
            reader = read_mod.FrameReader(b)
            for ftype, payload in frames:
                got_type, cur = reader.read()
                assert got_type == ftype and bytes(cur.buf[cur.off:]) == payload
            sender.close()
        finally:
            a.close()
            b.close()


def test_merge_expositions_matches_the_reference():
    engine = ("# HELP a_total A\n# TYPE a_total counter\na_total 3\n"
              'b_seconds_bucket{le="0.1"} 2\nb_seconds_sum 0.5\nb_seconds_count 2\n'
              '# HELP g gauge\n# TYPE g gauge\ng{proc="engine"} 1\n')
    workers = {
        "worker-0": ("# HELP a_total A\n# TYPE a_total counter\na_total 4\n"
                     'b_seconds_bucket{le="0.1"} 1\nb_seconds_sum 0.25\nb_seconds_count 1\n'
                     "# HELP w_only W\n# TYPE w_only counter\nw_only 7\n"),
        "worker-1": ('a_total 1.5\nw_only 2\ng{proc="engine"} 1\n'
                     '# HELP h_bucket H\nh_bucket{le="1"} 3\nbad line\n'),
    }
    for primary in (engine, engine + "# EOF\n", ""):
        assert (tstats.merge_expositions(primary, workers)
                == jstats.merge_expositions(primary, workers))
    assert tstats.merge_expositions(engine, {}) == jstats.merge_expositions(engine, {})


def test_worker_imports_neither_torch_nor_the_api():
    """A worker never touches the card: its module chain (``net/front.py``
    in place of the API's handler) leaves torch and the API unloaded."""
    import subprocess
    import sys

    from pilosa_tpu_torch.net import front, proto

    assert front.PROTOBUF_CONTENT_TYPE == proto.CONTENT_TYPE
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; import pilosa_tpu_torch.net.worker; "
            "print(sorted(m for m in ('torch', 'pilosa_tpu_torch.api', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- a node with two worker processes beside the reference's node --------------------


@pytest.fixture(scope="module")
def nodes():
    ja, ta = japi.API(), tapi.API(device="cpu")
    adm = AdmissionController()
    js, _ = jserve(ja, "localhost", 0)
    ts, _ = tserve(ta, "localhost", 0, workers=2, admission=adm)
    assert ts.wait_ready(60)
    ports = (js.server_address[1], ts.server_address[1])
    _schema(ports)
    _imports(ports)
    yield ja, ta, js, ts, ports, adm
    for srv in (js, ts):
        srv.shutdown()
        srv.server_close()
    ta.close()


def _worker_requests(ts, port):
    """{worker: inline requests} from each worker's summed-in registry."""
    send(port, "GET", "/metrics")
    out = {}
    for wid in range(ts.workers):
        text = ts._last_stats[wid]["text"]
        out[wid] = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                       if line.startswith('pilosa_server_requests_total{path="inline"}'))
    return out


def test_process_mode_answers_as_the_in_process_reference(nodes):
    ja, ta, js, ts, ports, _ = nodes
    before = _worker_requests(ts, ports[1])
    # Many short connections, so the kernel spreads them over all three
    # acceptors (the two workers and the owner's own reactor).
    for index, text in QUERIES:
        q(ports, index, text)
        q(ports, index, json.dumps({"query": text}))
    q(ports, "i", "Row(f=2)", path_suffix="?columnAttrs=true")
    q(ports, "i", json.dumps({"query": "Row(f=2)", "excludeColumns": True}))
    q(ports, "i", "Count(Row(f=1))", path_suffix="?shards=0,1")
    for _ in range(20):  # Count repeats: the memo lane's shape
        q(ports, "i", "Count(Intersect(Row(f=1), Row(g=2))) Count(Row(f=3))")
        q(ports, "i", "Count(Union(Row(f=1), Row(g=1)))")
    same(ports, "GET", "/export?index=i&field=f&shard=0")
    same(ports, "GET", "/internal/shards/max")
    same(ports, "POST", "/index/i/query", "Row(nope=1)", status=404)
    same(ports, "POST", "/index/i/query", "Row(f=", status=400)
    same(ports, "GET", "/schema")
    after = _worker_requests(ts, ports[1])
    assert all(after[w] > before[w] for w in after), (before, after)
    # One exposition for the node: every process up, worker series summed.
    _, ctype, text = send(ports[1], "GET", "/metrics")
    text = text.decode()
    assert ctype.startswith("text/plain")
    for proc in ("engine", "worker-0", "worker-1"):
        assert f'pilosa_process_up{{proc="{proc}"}} 1' in text
        assert f'pilosa_process_rss_bytes{{proc="{proc}"}}' in text
    total = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
             if line.startswith('pilosa_server_requests_total{path="inline"}')]
    assert total and total[0] >= sum(after.values())
    assert json.loads(send(ports[1], "GET", "/debug/vars")[2])["server"]["backend"] == "process"
    # Having served all of it, no worker has loaded torch.
    for pid in ts.worker_pids().values():
        with open(f"/proc/{pid}/maps") as f:
            assert "libtorch" not in f.read()


def test_observability_routes_through_the_workers(nodes):
    """Heat, the advisor and the fault plane live in the device owner: a
    worker passes their routes through, so every acceptor (the two workers
    and the owner's reactor) answers them from the owner's state."""
    from pilosa_tpu_torch.parallel.advisor import ADVISOR
    from pilosa_tpu_torch.util import plan_miner
    from pilosa_tpu_torch.util.heat import HEAT

    _, ta, _, _, ports, _ = nodes
    HEAT.reset()
    plan_miner.MINER.reset()
    ADVISOR.reset()
    ta.engine.result_memo.clear()
    for _ in range(4):
        for text in ("Count(Intersect(Row(f=1), Row(f=2)))", "Count(Intersect(Row(f=3), Row(g=1)))"):
            status, _, out = send(ports[1], "POST", "/index/i/query", text.encode())
            assert status == 200, out
    docs = {}
    for path in ("/debug/heat?index=i&topk=3", "/debug/prefetch_advice", "/debug/faults",
                 "/debug/sequences"):
        got = [send(ports[1], "GET", path) for _ in range(12)]
        assert {g[0] for g in got} == {200}, got[0]
        docs[path] = [json.loads(g[2]) for g in got]
        assert all(d == docs[path][0] for d in docs[path]), path
    heat = docs["/debug/heat?index=i&topk=3"][0]
    assert heat["plansObserved"] == 8 and {t["field"] for t in heat["tables"]} == {"f", "g"}
    assert heat == HEAT.to_doc(index="i", topk=3)
    adv = docs["/debug/prefetch_advice"][0]
    assert adv == ADVISOR.to_doc() and adv["outstanding"] is not None


@pytest.mark.parametrize("method,path", [
    ("GET", "/debug/pprof"), ("GET", "/debug/pprof/goroutine"),
    ("GET", "/debug/pprof/profile?seconds=0.1&hz=100"), ("GET", "/debug/pprof/heap?reset=true"),
    ("POST", "/debug/pprof/trace?seconds=0.1"), ("POST", "/recalculate-caches"),
])
def test_pprof_and_recalculate_routes_through_the_workers(nodes, method, path):
    """The routes this node ports from item 14 pass through a worker to
    the device owner, as the reference's: every acceptor answers 200 with
    the owner's document (its threads, its trace file)."""
    _, _, _, ts, ports, _ = nodes
    got = [send(ports[1], method, path) for _ in range(6)]
    assert {g[0] for g in got} == {200}, got[0]
    docs = [json.loads(g[2]) for g in got]
    if path == "/debug/pprof":
        # The owner's threads: its process pool runs the passthrough.
        assert all(d["count"] >= 1 for d in docs)
    if path.startswith("/debug/pprof/trace"):
        assert all(os.path.exists(d["traceFile"]) for d in docs)
    if path == "/recalculate-caches":
        assert docs == [{}] * 6


def test_admission_is_global_across_workers(nodes):
    _, _, _, ts, ports, adm = nodes
    tplans.LEDGER.reset()
    held = [f"hold{k}" for k in range(adm.hard_limit)]
    for t in held:
        assert adm.admit(t) is None
    try:
        statuses = [send(ports[1], "POST", "/index/i/query", b"Count(Row(f=1))",
                         {"X-Pilosa-Tenant": "z"})[0] for _ in range(8)]
    finally:
        for t in held:
            adm.release(t)
    assert statuses == [503] * 8
    assert tplans.LEDGER.snapshot()["z"]["sheds"] == 8
    assert send(ports[1], "POST", "/index/i/query", b"Count(Row(f=1))")[0] == 200


def _held(eng):
    """The engine's batcher with its workers held until ``release``: every
    submit queues, so one drain holds exactly the items queued before."""
    b = eng._batcher = CountBatcher(eng)
    b._last_fused = time.monotonic() + 10_000
    b._workers_started = True

    def release(n, timeout=60.0):
        deadline = time.monotonic() + timeout
        while len(b._queue) < n:
            assert time.monotonic() < deadline, "items never queued"
            time.sleep(0.005)
        with b._lock:
            b._workers_started = False
            b._ensure_workers()
            b._cond.notify_all()

    return b, release


def _link(path, wid):
    """A worker's engine link: the AF_UNIX connection and its HELLO."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(60)
    s.connect(path)
    tipc.send_frame(s, threading.Lock(), tipc.HELLO, tipc.pack_hello(wid, os.getpid()))
    return s


def test_cross_worker_coalescing(nodes):
    ja, ta, _, ts, _, _ = nodes
    # Queries no earlier test asked: a result-memo hit would answer at
    # submit time and queue nothing.
    texts = ["Count(Xor(Row(f=4), Row(g=1)))", "Count(Intersect(Row(f=5), Row(g=0)))"]
    want = [ja.query(japi.QueryRequest("i", t)).results for t in texts]
    links = [_link(ts.ipc_path, 40 + k) for k in range(2)]
    deadline = time.monotonic() + 30
    while not {40, 41} <= set(ts.worker_pids()):
        assert time.monotonic() < deadline, "links never registered"
        time.sleep(0.01)
    b, release = _held(ta.engine)
    try:
        for k, (s, text) in enumerate(zip(links, texts)):
            tipc.send_frame(s, threading.Lock(), tipc.QUERY,
                            tipc.pack_query(100 + k, 0, "i", text, "t", None, None, None))
        release(2)
        got = []
        for k, s in enumerate(links):
            ftype, cur = tipc.read_frame(s)
            assert ftype == tipc.RESULT_FAST
            rid, trace_id, results = tipc.unpack_result_fast(cur)
            assert rid == 100 + k and trace_id
            got.append(results)
        snap = b.pipeline_snapshot()
    finally:
        for s in links:
            s.close()
        b.stop()
        ta.engine._batcher = None
        deadline = time.monotonic() + 30
        while set(ts.worker_pids()) - {0, 1}:  # the owner drops closed links
            assert time.monotonic() < deadline, "closed links never dropped"
            time.sleep(0.01)
    assert got == want
    assert b.batches == 1 and b.batched_queries == 2
    assert snap["counters"]["cross_worker_fused_batches"] == 1


def test_count_lane_goes_through_the_batcher():
    """Two synchronous Counts queued while the batcher is held ride one K5
    batch (the executor's lane is ``batched_count``); a lone Count, with
    the pipe idle, runs directly with no batch."""
    ja, ta = japi.API(), tapi.API(device="cpu")
    rng = np.random.default_rng(4)
    cols = rng.choice(3 * SW, 20000, replace=False)
    rows = rng.integers(0, 4, len(cols))
    for a in (ja, ta):
        a.create_index("i").create_field("f").import_bulk(rows.tolist(), cols.tolist())
    texts = ["Count(Intersect(Row(f=1), Row(f=2)))", "Count(Union(Row(f=0), Row(f=3)))"]
    want = [ja.query(japi.QueryRequest("i", t)).results for t in texts]
    eng = ta.engine
    try:
        b, release = _held(eng)
        out = {}
        threads = [threading.Thread(target=lambda k=k: out.__setitem__(
            k, ta.query(tapi.QueryRequest("i", texts[k])).results)) for k in range(2)]
        for th in threads:
            th.start()
        release(2)
        for th in threads:
            th.join(60)
            assert not th.is_alive()
        assert [out[0], out[1]] == want
        assert b.batches == 1 and b.batched_queries == 2 and eng.batch_dispatches == 1
        b.stop()
        eng._batcher = None
        lone = eng.batcher()
        dense = eng.dense_dispatches
        assert ta.query(tapi.QueryRequest("i", "Count(Xor(Row(f=1), Row(f=3)))")).results == \
            ja.query(japi.QueryRequest("i", "Count(Xor(Row(f=1), Row(f=3)))")).results
        assert lone.batches == 0 and eng.dense_dispatches == dense + 1
    finally:
        ta.close()


def _readyz(port):
    """/readyz's status, or None where the connection was reset: a
    connection the kernel gave the killed worker's listener dies with it."""
    try:
        return send(port, "GET", "/readyz")[0]
    except ConnectionError:
        return None


def test_worker_kill_is_respawned_and_flips_readyz(nodes):
    _, _, _, ts, ports, _ = nodes
    pids = {w: p for w, p in ts.worker_pids().items() if w < ts.workers}
    restarts = ts.restarts
    os.kill(pids[0], signal.SIGKILL)
    deadline = time.monotonic() + 30
    while _readyz(ports[1]) != 503:
        assert time.monotonic() < deadline, "readyz never turned 503"
        time.sleep(0.01)
    assert ts.wait_ready(60)
    assert _readyz(ports[1]) == 200
    assert ts.restarts == restarts + 1 and ts.worker_pids()[0] != pids[0]
    for _ in range(10):
        q(ports, "i", "Count(Intersect(Row(f=1), Row(g=2)))")
