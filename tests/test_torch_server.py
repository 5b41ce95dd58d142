"""The port's node assembly (pilosa_tpu_torch.server, .config) against the
JAX package's (pilosa_tpu.server, .config).

- ``Config``: the same TOML text, environment and flags give the same
  attributes in both packages, and ``generate-config`` (``to_toml``) is
  the same text; the keys this port does not serve yet raise at
  ``Server`` construction, naming their ROADMAP.md item.
- ``Server(cfg, device="cpu").open(port_override=0)`` serves, and a
  restart on the same data directory answers the same; a data directory
  written by the reference's Server opens in the port's with identical
  answers, and the other way round.
- The warm start: ``/readyz`` answers 503 with a ``warming`` reason while
  the engine's ``warm_state`` is not done, and 200 once it is.
- ``Server(cfg)`` with no device runs on the card, so it raises where
  there is none (this machine); ``[mesh] devices = -1`` serves with no
  engine.
- ``[engine] device-budget-bytes`` reaches the engine as its device budget
  and shows on /debug/vars and /readyz.
- ``[server] workers = 2`` serves in process mode, with the reference's
  Server's answers on the same data.
- The six observability routes and three keys that answered 501 or were
  refused before (``/debug/faults`` GET and POST, ``/debug/history``,
  ``/debug/heat``, ``/debug/prefetch_advice``, ``/debug/flightrecorder``;
  ``[faults] rules``, ``[observability] history``, ``[metric] service =
  statsd``) answer 200 with the reference's document shape, or start a
  node that serves them as the reference's does.
- statsd datagrams byte for byte, the diagnostics payload's keys and
  version compare, the import fan-out's width, results and errors, and
  multi-shard imports through it.

Answers are ids and counts: exact agreement (tolerance 0)."""

import http.client
import json
import time
import types

import pytest
import torch

from pilosa_tpu import api as japi
from pilosa_tpu.config import Config as JConfig
from pilosa_tpu.net import InternalClient as JClient
from pilosa_tpu.server import Server as JServer
from pilosa_tpu_torch import api as tapi
from pilosa_tpu_torch.config import Config as TConfig
from pilosa_tpu_torch.net import InternalClient as TClient
from pilosa_tpu_torch.net.client import ClientError
from pilosa_tpu_torch.server import Server as TServer

TOML = """data-dir = "/from/file"
bind = "127.0.0.1:7777"
max-writes-per-request = 12
verbose = true

[cluster]
replicas = 3
long-query-time = "1m30s"
hint-max-age = "2h"

[gossip]
probe-interval = "250ms"
seeds = ["a:1", "b:2"]

[metric]
service = "expvar"
poll-interval = "10s"

[tracing]
sampler-type = "none"

[server]
backend = "threaded"
max-inflight = 64
tenant-weights = "gold=4,free=1"
read-timeout = "3s"

[storage]
ack = "fsynced"
warm-start = false

[mesh]
devices = -1
jax-coordinator = "h:1234"

[observability]
sample-interval = "1500ms"
"""

ENV = {
    "PILOSA_TPU_DATA_DIR": "/from/env",
    "PILOSA_TPU_CLUSTER_HOSTS": "x,y",
    "PILOSA_TPU_STORAGE_WARM_START": "true",
    "PILOSA_TPU_FAULTS": "drop peer=a; error status=503",
    "PILOSA_TPU_READ_TIMEOUT": "2m",
    "PILOSA_TPU_MESH_DEVICES": "1",
}


def test_config_file_env_and_flags_agree(tmp_path):
    p = tmp_path / "cfg.toml"
    p.write_text(TOML)
    cfgs = []
    for cls in (JConfig, TConfig):
        cfg = cls()
        cfg.load_file(str(p))
        cfg.load_env(ENV)
        cfg.bind = ":9999"  # a flag, as cli._load_config applies it
        cfgs.append(cfg)
    assert vars(cfgs[1]) == vars(cfgs[0])
    assert cfgs[1].data_dir == "/from/env" and cfgs[1].cluster_long_query_time == 90.0
    assert cfgs[1].bind_host_port() == cfgs[0].bind_host_port() == ("0.0.0.0", 9999)
    assert cfgs[1].to_toml() == cfgs[0].to_toml()


def test_generate_config_is_the_reference_text(tmp_path):
    assert TConfig().to_toml() == JConfig().to_toml()
    assert vars(TConfig()) == vars(JConfig())
    p = tmp_path / "gen.toml"
    p.write_text(TConfig().to_toml())
    back = TConfig()
    back.load_file(str(p))
    assert back.to_toml() == TConfig().to_toml()


# The [mesh] keys the port refused until the multi-process mesh was
# ported, with the ROADMAP.md item that ported them: all served now.
_MESH_ITEM = "Queue 1 item 15 part C (the multi-process mesh)"
_MESH_KEYS = (
    ("jax_coordinator", "[mesh] coordinator", _MESH_ITEM),
    ("jax_num_processes", "[mesh] processes", _MESH_ITEM),
    ("jax_process_id", "[mesh] process-id", _MESH_ITEM),
    ("mesh_peers", "[mesh] peers", _MESH_ITEM),
    ("mesh_sequencer", "[mesh] sequencer", _MESH_ITEM),
)


def _refused_cases():
    cases = list(_MESH_KEYS)
    cases.append(("mesh_devices", "[mesh] devices", "item 15"))
    return cases


_CHANGED = {
    "cluster_coordinator": True, "cluster_replicas": 2, "cluster_hosts": ["h:1"],
    "cluster_replica_read": "any", "cluster_freshness_ms": 5.0,
    "cluster_hint_max_bytes": 0, "cluster_hint_max_age": 60.0,
    "cluster_recovery_holddown_ms": 1.0, "gossip_port": 15000, "gossip_seeds": ["s:1"],
    "gossip_probe_interval": 2.0, "gossip_probe_timeout": 1.0,
    "gossip_push_pull_interval": 5.0, "gossip_suspicion_mult": 2,
    "translation_primary_url": "http://p:1", "jax_coordinator": "c:1",
    "jax_num_processes": 2, "jax_process_id": 1, "mesh_peers": ["http://q:1"],
    "mesh_sequencer": "self", "server_workers": 2, "faults_rules": ["drop peer=a"],
    "obs_history": True, "engine_device_budget_bytes": 1 << 20,
    "metric_service": "statsd", "mesh_devices": 2,
}


@pytest.mark.parametrize("attr,key,item", _refused_cases())
def test_unserved_keys_raise_naming_their_item(tmp_path, attr, key, item):
    """The multi-process mesh's keys, refused before it was ported, now
    build a Server (the process group comes up at open:
    tests/test_torch_multihost.py).  ``[mesh] devices`` past the cards the
    process has leaves the node without an engine and logs the
    reference's "requested N devices, only M available", as the
    reference's node does; the node still answers from the host lane."""
    cfg = TConfig()
    cfg.data_dir = str(tmp_path)
    setattr(cfg, attr, _CHANGED[attr])
    if attr != "mesh_devices":
        assert TServer(cfg, device="cpu").config.__dict__[attr] == _CHANGED[attr]
        return
    cfg.bind = "localhost:0"
    srv = TServer(cfg, device="cpu")
    lines = []
    srv.logger = types.SimpleNamespace(printf=lambda fmt, *a: lines.append(fmt % a))
    srv.open(port_override=0)
    try:
        assert srv.engine is None and srv.api.engine is None
        assert any("requested 2 devices, only 1 available" in x for x in lines), lines
        c = _client(srv)
        c.create_index("i")
        c.create_field("i", "f")
        c.import_bits("i", "f", 0, [1, 1], [3, 9])
        assert c.query("i", "Count(Row(f=1))")["results"] == [2]
    finally:
        srv.close()


def _cfg(cls, path, **kw):
    cfg = cls()
    cfg.data_dir = str(path)
    cfg.bind = "localhost:0"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _open(cls, cfg):
    if cls is TServer:
        return TServer(cfg, device="cpu").open(port_override=0)
    return JServer(cfg).open(port_override=0)


def _client(srv):
    return TClient(f"http://localhost:{srv.port}")


WRITES = [
    ("i", "Set(1, f=10) Set(2, f=10) Set(3, f=11) Set(2, f=11) Set(1048577, f=10)"),
    ("i", "SetRowAttrs(f, 10, color=\"red\")"),
]
READS = [
    ("i", "Count(Intersect(Row(f=10), Row(f=11)))"),
    ("i", "Row(f=10)"),
    ("i", "TopN(f, n=2)"),
    ("i", "Count(Union(Row(f=10), Row(f=11)))"),
    ("k", "Row(kf=\"a\")"),
    ("k", "Count(Row(kf=\"b\"))"),
]


def _fill(client):
    client.create_index("i")
    client.create_field("i", "f")
    client.create_index("k", keys=True)
    client.create_field("k", "kf", {"keys": True})
    for index, text in WRITES:
        client.query(index, text)
    client.import_keyed_bits("k", "kf", ["a", "b", "a"], ["x", "y", "z"])


def _answers(client):
    out = []
    for index, text in READS:
        doc = client.query(index, text)
        assert "traceID" in doc
        out.append(doc["results"])
    return out


def test_server_serves_and_restarts(tmp_path):
    cfg = _cfg(TConfig, tmp_path / "data")
    srv = _open(TServer, cfg)
    try:
        c = _client(srv)
        _fill(c)
        first = _answers(c)
        node_id = srv.node_id
        assert c.status()["localID"] == node_id
        assert c.status()["nodes"][0]["uri"] == f"http://localhost:{srv.port}"
    finally:
        srv.close()
    srv = _open(TServer, cfg)
    try:
        assert srv.node_id == node_id  # the .id file persisted
        c = _client(srv)
        assert _answers(c) == first
        assert c.readiness()["ready"] is True
        assert b"pilosa_server_requests_total" in c._get("/metrics", raw=True)
    finally:
        srv.close()
    assert first[0] == [1] and first[1][0]["columns"] == [1, 2, 1048577]
    assert first[1][0]["attrs"] == {"color": "red"}


def test_server_workers_serves_in_process_mode(tmp_path):
    """``[server] workers = 2``: two worker processes beside the device
    owner's own reactor, /readyz 200 once both say HELLO, and the answers
    of the reference's Server on the same data."""
    path = tmp_path / "data"
    srv = _open(JServer, _cfg(JConfig, path))
    try:
        c = _client(srv)
        _fill(c)
        want = _answers(c)
    finally:
        srv.close()
    srv = _open(TServer, _cfg(TConfig, path, server_workers=2))
    try:
        http = srv._http
        assert http.wait_ready(60) and len(http.worker_pids()) == 2
        c = _client(srv)
        assert c.readiness()["ready"] is True
        assert _answers(c) == want
        assert b'pilosa_process_up{proc="worker-1"} 1' in c._get("/metrics", raw=True)
    finally:
        srv.close()


def test_history_samples_the_whole_node_in_process_mode(tmp_path):
    """With workers, the history samples the node's aggregated exposition
    (every worker's registry summed in, ``snapshot_from_exposition``), as
    the reference's Server does: the per-process gauges are series of it."""
    srv = _open(TServer, _cfg(TConfig, tmp_path / "data", server_workers=2, obs_history=True,
                              obs_sample_interval=3600.0))
    try:
        assert srv._http.wait_ready(60)
        c = _client(srv)
        _fill(c)
        hist = srv.api.history
        assert hist._snapshot_fn.__name__ == "<lambda>"
        now = float(int(time.time()))
        assert hist.tick(now=now) > 0
        _answers(c)
        assert hist.tick(now=now + 3600.0) > 0
        up = hist.query("pilosa_process_up", since=now - 1, until=now + 3601.0)["points"]
        assert {"proc=worker-0", "proc=worker-1", "proc=engine"} <= set(up)
        assert all(v == 1000 for series in up.values() for _, v in series)
        rates = hist.query("pilosa_server_requests_total_rate", since=now, until=now + 3601.0)
        assert any(v for series in rates["points"].values() for _, v in series)
    finally:
        srv.close()


@pytest.mark.parametrize("writer,reader", [(JServer, TServer), (TServer, JServer)])
def test_data_directory_opens_in_the_other_package(tmp_path, writer, reader):
    """A directory written by one package's Server opens in the other's
    with identical answers (through both packages' wire formats)."""
    path = tmp_path / "data"
    srv = _open(writer, _cfg(JConfig if writer is JServer else TConfig, path))
    try:
        c = _client(srv)
        _fill(c)
        want = _answers(c)
    finally:
        srv.close()
    srv = _open(reader, _cfg(JConfig if reader is JServer else TConfig, path))
    try:
        got = _answers(_client(srv))
        jgot = [JClient(f"http://localhost:{srv.port}").query(i, t)["results"]
                for i, t in READS]
    finally:
        srv.close()
    assert got == want == jgot


def test_device_budget_reaches_the_engine_and_the_debug_surfaces(tmp_path):
    """``[engine] device-budget-bytes`` below one full stack: the Server
    starts, hands the budget to its engine (``max_resident_bytes``), every
    answer equals the reference Server's under the same budget (cold ones
    from the host tier, then from the promoted block pool), and /debug/vars
    (``engineCaches``) and /readyz (``residency``) report it.  Closing the
    Server stops the residency worker."""
    import threading

    budget = 3 * (32768 * 4 + 16)  # f holds 2 rows x 2 shards of them
    answers = []
    for cls in (JServer, TServer):
        cfg = _cfg(JConfig if cls is JServer else TConfig, tmp_path / cls.__module__,
                   engine_device_budget_bytes=budget)
        srv = _open(cls, cfg)
        try:
            c = _client(srv)
            _fill(c)
            got = [_answers(c)]
            if cls is TServer:
                assert srv.engine.max_resident_bytes == budget
                assert srv.engine.host_fallbacks >= 1
                assert srv.engine.residency.flush(30.0)
                fb = srv.engine.host_fallbacks
                for index, text in (READS[0], READS[3]):
                    c.query(index, text)
                assert srv.engine.host_fallbacks == fb  # Counts from the pool
                got.append(_answers(c))  # TopN needs the full stack: host tier
                caches = c._get("/debug/vars")["engineCaches"]
                assert caches["deviceBudgetBytes"] == budget
                assert caches["partialStacks"] >= 1 and caches["hostFallbacks"] > fb
                assert caches["residency"]["partialPromotions"] >= 1
                assert caches["workingSet"]["deviceBudgetBytes"] == budget
                res = c._get("/readyz")["residency"]
                assert res["deviceBudgetBytes"] == budget and 0.0 < res[
                    "residentBlockFraction"] <= 1.0
                assert res["residentBytes"] <= budget
            answers.append(got[-1])
        finally:
            srv.close()
    assert answers[0] == answers[1]
    assert not [t for t in threading.enumerate()
                if t.name == "residency-promote" and t.is_alive()]


def test_readyz_reports_warming_until_the_warm_start_is_done(tmp_path):
    cfg = _cfg(TConfig, tmp_path / "data")
    srv = _open(TServer, cfg)
    try:
        _fill(_client(srv))
    finally:
        srv.close()
    srv = _open(TServer, cfg)
    try:
        c = _client(srv)
        for t in srv._monitors:
            if t.name == "warm-start":
                t.join(30)
        ws = srv.engine.warm_state
        assert ws["done"] and ws["skipped"] == 0 and ws["built"] == ws["total"] >= 3
        assert srv.engine.stack_rebuilds == ws["built"]
        srv.engine.warm_state = {"total": 4, "built": 1, "skipped": 0, "done": False}
        with pytest.raises(ClientError) as e:
            c._get("/readyz")
        assert e.value.code == 503
        doc = json.loads(e.value.body)
        assert doc["ready"] is False and doc["reasons"] == [
            "warming: residency 25% (1/4 stacks)"]
        assert doc["warming"] == {"done": False, "built": 1, "total": 4, "skipped": 0,
                                  "fraction": 0.25}
        assert c.readiness()["warming"]["done"] is False
        srv.engine.warm_state["done"] = True
        assert c._get("/readyz")["ready"] is True
        # Queries answer while warming, and after.
        assert _answers(c)[0] == [1]
    finally:
        srv.close()


def test_warm_start_off_and_no_engine(tmp_path):
    cfg = _cfg(TConfig, tmp_path / "data", storage_warm_start=False)
    srv = _open(TServer, cfg)
    try:
        _fill(_client(srv))
        assert srv.engine.warm_state is None
        assert _client(srv).readiness() == {"ready": True, "reasons": [], "state": "NORMAL"}
    finally:
        srv.close()
    srv = _open(TServer, _cfg(TConfig, tmp_path / "data", mesh_devices=-1))
    try:
        assert srv.engine is None and srv.api.engine is None
        assert _answers(_client(srv))[0] == [1]
    finally:
        srv.close()


def test_server_without_a_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TServer(_cfg(TConfig, tmp_path / "data"))


def test_debug_surfaces(tmp_path):
    """/debug/vars (the expvar stats client's per-call counts, the engine's
    counters, the reactor), /debug/traces (the span of a response's
    traceID), /debug/events (the node's journal, filtered by type) and
    /healthz, on a node with ``[metric] service = "expvar"``."""
    cfg = _cfg(TConfig, tmp_path / "data", metric_service="expvar")
    srv = _open(TServer, cfg)
    try:
        c = _client(srv)
        _fill(c)
        doc = c.query("i", "Count(Intersect(Row(f=10), Row(f=11))) TopN(f, n=2)")
        dv = c._get("/debug/vars")
        assert dv["counters"]["Count,index:i"] >= 1 and dv["counters"]["TopN,index:i"] == 1
        assert dv["engine"]["device"] == "cpu" and dv["server"]["backend"] == "async"
        assert "pilosa_server_requests_total" in dv["metrics"]["counters"]
        traces = c._get("/debug/traces")
        assert doc["traceID"] in {t["traceID"] for t in traces["recent"]}
        assert {t["name"] for t in traces["recent"]} == {"api.Query"}
        ev = c._get("/debug/events?type=server")
        assert ev["node"] == srv.node_id and ev["events"] == []
        assert c._get("/healthz")["status"] == "ok"
    finally:
        srv.close()
    ev = srv.journal.to_doc(type="server")
    assert [e["type"] for e in ev["events"]] == ["server.shutdown"]


def test_profiler_tracer_marks_spans_for_torch_profiler():
    """``[tracing] sampler-type = "profiler"``: spans open a
    torch.profiler range of their name, and still land in the rings."""
    from torch.profiler import ProfilerActivity, profile

    from pilosa_tpu_torch.util import NopTracer, ProfilerTracer

    tracer = ProfilerTracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.start_span("api.Query", index="i") as span:
            torch.ones(4).sum()
    assert "api.Query" in {e.key for e in prof.key_averages()}
    assert [t["traceID"] for t in tracer.traces()["recent"]] == [span.trace_id]
    with NopTracer().start_span("x") as none:
        assert none is None


# -- the observability routes and keys (formerly 501s and refusals) -------------------


def _shape(doc):
    """A JSON document's shape: its keys, recursively, and the type of each
    leaf; list elements by their first entry's shape."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_shape(doc[0])] if doc else []
    return type(doc).__name__ if doc is not None else None


def _obs_pair(tmp_path, **kw):
    """A reference Server and a port Server on data directories of their
    own, with the same config: history on, its monitor idle (the tests
    tick the samplers and watchers by hand, at the same instants)."""
    kw.setdefault("obs_history", True)
    kw.setdefault("obs_sample_interval", 3600.0)  # the test ticks by hand
    kw.setdefault("obs_slo_error_rate", 0.01)
    # The heat recorder, the transition miner and the advisor are process
    # singletons in each package: both start from nothing, so what other
    # tests of this worker queried before cannot make the two advisors'
    # documents differ.
    from pilosa_tpu.parallel.advisor import ADVISOR as JADVISOR
    from pilosa_tpu.util import plan_miner as jminer
    from pilosa_tpu.util.heat import HEAT as JHEAT
    from pilosa_tpu_torch.parallel.advisor import ADVISOR as TADVISOR
    from pilosa_tpu_torch.util import plan_miner as tminer
    from pilosa_tpu_torch.util.heat import HEAT as THEAT

    for obj in (JHEAT, jminer.MINER, JADVISOR, THEAT, tminer.MINER, TADVISOR):
        obj.reset()
    out = []
    for cls in (JServer, TServer):
        cfg = _cfg(JConfig if cls is JServer else TConfig, tmp_path / cls.__module__, **kw)
        out.append(_open(cls, cfg))
    return out


_OBS_CASES = [
    ("route", "GET", "/debug/faults"),
    ("route", "POST", "/debug/faults"),
    ("route", "GET", "/debug/history?series=pilosa_history_ticks_total_rate"),
    ("route", "GET", "/debug/heat"),
    ("route", "GET", "/debug/prefetch_advice"),
    ("route", "GET", "/debug/flightrecorder"),
    ("key", "faults_rules", ["error peer=serve route=/nothing status=503"]),
    ("key", "obs_history", True),
    ("key", "metric_service", "statsd"),
]


@pytest.mark.parametrize("kind,a,b", _OBS_CASES, ids=[f"{c[0]}-{c[1]}-{c[2]}"[:60]
                                                        for c in _OBS_CASES])
def test_observability_routes_and_keys_serve(tmp_path, kind, a, b):
    """The six routes and three keys of ROADMAP.md Queue 1 item 14 that
    answered 501 or refused the node before: each route answers 200 with
    the reference's document shape, and a node starts with each key and
    serves it as the reference's does."""
    import socket

    from pilosa_tpu.net.faults import PLANE as JPLANE
    from pilosa_tpu_torch.net.faults import PLANE as TPLANE

    sock = None
    kw = {}
    if kind == "key" and a == "metric_service":
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("127.0.0.1", 0))
        sock.settimeout(5.0)
        kw = {"metric_service": "statsd", "metric_host": f"127.0.0.1:{sock.getsockname()[1]}"}
    elif kind == "key":
        kw = {a: b}
    servers = _obs_pair(tmp_path, **kw)
    try:
        clients = [_client(s) for s in servers]
        for c in clients:
            c.create_index("i")
            c.create_field("i", "f")
            c.query("i", "Set(1, f=1) Set(2, f=2)")
            # Three Counts: the advisor learns the Count -> Count transition
            # on the second and grades its advice on the third, so that
            # /debug/prefetch_advice carries a graded prediction.
            for _ in range(3):
                c.query("i", "Count(Intersect(Row(f=1), Row(f=2)))")
        now = float(int(time.time()))
        for s in servers:
            if s.api.history is not None:
                for k in range(2):
                    s.api.history.tick(now=now + k)
                    s.api.slo.tick(now=now + k)
        if kind == "route":
            body = json.dumps({"seed": 1, "rules": ["delay peer=serve route=/x ms=0"]}).encode()
            docs = []
            for s in servers:
                conn = http.client.HTTPConnection("localhost", s.port, timeout=30)
                conn.request(a, b, body=body if a == "POST" else None)
                r = conn.getresponse()
                assert r.status == 200, (b, r.read())
                docs.append(json.loads(r.read()))
                conn.close()
            if b.startswith("/debug/flightrecorder"):
                assert set(docs[1]) == set(docs[0])
            else:
                assert _shape(docs[1]) == _shape(docs[0]), b
            if b == "/debug/prefetch_advice":
                assert docs[0]["lastGrade"] is not None and docs[1]["lastGrade"] is not None
        elif a == "faults_rules":
            docs = [c._get("/debug/faults") for c in clients]
            assert docs[1]["rules"] == docs[0]["rules"] == [TPLANE.snapshot()["rules"][0]]
            assert [e["type"] for e in servers[1].journal.to_doc(type="faults")["events"]] == [
                "faults.configure"]
        elif a == "obs_history":
            vars_ = [c._get("/debug/vars") for c in clients]
            for key in ("history", "slo"):
                assert _shape(vars_[1][key]) == _shape(vars_[0][key]), key
            ready = [c._get("/readyz") for c in clients]
            assert ready[1]["degraded"] == ready[0]["degraded"] == []
        else:
            from pilosa_tpu_torch.util.statsd import StatsdClient

            assert isinstance(servers[1].stats, StatsdClient)
            names = set()
            while True:
                try:
                    names.add(sock.recv(65536).split(b":")[0])
                except socket.timeout:
                    break
                if len(names) >= 2:
                    break
            assert names, "no statsd datagram arrived"
    finally:
        for s in servers:
            s.close()
        for plane in (JPLANE, TPLANE):
            plane.configure([])
        if sock is not None:
            sock.close()


class _FakeSock:
    def __init__(self):
        self.sent = []

    def sendto(self, data, addr):
        self.sent.append((data, addr))


def test_statsd_datagrams_are_the_reference_bytes():
    from pilosa_tpu.util.statsd import StatsdClient as JStatsd
    from pilosa_tpu_torch.util.statsd import StatsdClient as TStatsd

    sent = []
    for cls in (JStatsd, TStatsd):
        sock = _FakeSock()
        sock._statsd_addr = ("127.0.0.1", 8125)
        c = cls(prefix="p", _sock=sock).with_tags("a:1", "b:2")
        c.count("q", 3, rate=0.5, tags=["x:y"])
        c.gauge("g", 1.25)
        c.histogram("h", 7)
        c.set("s", "v")
        c.timing("t", 0.0005)
        c.timing("t", 2.0)
        c.with_tags("c:3").count("z")
        sent.append(sock.sent)
    assert sent[1] == sent[0]
    assert sent[1][4][0] == b"p.t:0.5|ms|#a:1,b:2"


def test_diagnostics_payload_keys_and_version_compare():
    from pilosa_tpu.util.diagnostics import Diagnostics as JDiag
    from pilosa_tpu_torch.util.diagnostics import Diagnostics as TDiag

    apis = [japi.API(), tapi.API(device="cpu")]
    for a in apis:
        a.create_index("i")
        a.create_field("i", "t", {"type": "time", "timeQuantum": "YMD"})
    docs = [cls(api=a).collect() for cls, a in zip((JDiag, TDiag), apis)]
    assert set(docs[1]) == set(docs[0])
    for k in ("version", "os", "arch", "numIndexes", "numFields", "fieldTypes",
              "timeQuantumEnabled", "clusterSize"):
        assert docs[1][k] == docs[0][k], k
    assert docs[1]["devicePlatform"] == "cpu"
    for local, latest in (("v1.2.3", "v2.0.0"), ("v1.2.3", "v1.3.0"), ("v1.2.3", "v1.2.4"),
                          ("v1.2.3", "v1.2.3"), ("bad", "v1.0.0")):
        assert TDiag._compare_version(local, latest) == JDiag._compare_version(local, latest)
    d = TDiag(api=apis[1])
    d.flush()  # no endpoint: stored locally, nothing sent
    assert set(d.last_report) == set(docs[1])
    apis[1].close()


@pytest.mark.parametrize("env,n", [(None, 20), ("1", 5), ("3", 2), ("x", 9), ("0", 4)])
def test_fanout_width_and_results(monkeypatch, env, n):
    from pilosa_tpu.util import fanout as jfan
    from pilosa_tpu_torch.util import fanout as tfan

    if env is None:
        monkeypatch.delenv("PILOSA_IMPORT_FANOUT", raising=False)
    else:
        monkeypatch.setenv("PILOSA_IMPORT_FANOUT", env)
    assert tfan.fanout_width(n) == jfan.fanout_width(n)
    tasks = [lambda k=k: k * k for k in range(n)]
    assert tfan.run_fanout(tasks) == jfan.run_fanout(tasks) == [k * k for k in range(n)]

    def boom(k):
        if k in (1, 3):
            raise ValueError(f"task {k}")
        return k

    errs = []
    for mod in (jfan, tfan):
        with pytest.raises(ValueError) as e:
            mod.run_fanout([lambda k=k: boom(k) for k in range(n)])
        errs.append(str(e.value))
    assert errs[1] == errs[0] == "task 1"


def test_multi_shard_imports_fan_out_as_the_reference():
    """Bulk bit and value imports over many shards apply their
    per-fragment groups through the fan-out and answer as the
    reference's."""
    import numpy as np

    rng = np.random.default_rng(5)
    cols = rng.choice(12 << 20, 40000, replace=False)
    rows = rng.integers(0, 5, len(cols))
    vals = rng.integers(-50, 1000, len(cols))
    apis = [japi.API(), tapi.API(device="cpu")]
    for a in apis:
        a.create_index("i")
        a.create_field("i", "f")
        a.create_field("i", "v", {"type": "int", "min": -50, "max": 1000})
        a.index("i").field("f").import_bulk(rows.tolist(), cols.tolist())
        a.index("i").field("v").import_values(cols.tolist(), vals.tolist())
    for q in ("Count(Row(f=3))", "Sum(field=v)", "Count(Range(v > 500))", "TopN(f, n=3)"):
        got = [a.query((japi if k == 0 else tapi).QueryRequest("i", q)).results
               for k, a in enumerate(apis)]
        assert str(got[1]) == str(got[0]), q
    apis[1].close()
