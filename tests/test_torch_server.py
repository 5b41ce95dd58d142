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

Answers are ids and counts: exact agreement (tolerance 0)."""

import json

import pytest
import torch

from pilosa_tpu.config import Config as JConfig
from pilosa_tpu.net import InternalClient as JClient
from pilosa_tpu.server import Server as JServer
from pilosa_tpu_torch.config import Config as TConfig
from pilosa_tpu_torch.net import InternalClient as TClient
from pilosa_tpu_torch.net.client import ClientError
from pilosa_tpu_torch.server import _UNPORTED_KEYS
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


def _refused_cases():
    cases = [(attr, key, item) for attr, key, item in _UNPORTED_KEYS]
    cases.append(("metric_service", "[metric] service", "item 14"))
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
    cfg = TConfig()
    cfg.data_dir = str(tmp_path)
    setattr(cfg, attr, _CHANGED[attr])
    with pytest.raises(NotImplementedError) as e:
        TServer(cfg, device="cpu")
    assert key in str(e.value) and item.split(" (")[0] in str(e.value)


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
