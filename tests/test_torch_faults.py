"""The deterministic fault plane in the port (``pilosa_tpu_torch/net/faults.py``
and its intercepts in ``net/server.py`` and ``net/client.py``) against the
JAX package's.

- The same seed and rule schedule give the same verdict sequence, the same
  per-rule tallies and the same ``snapshot``; bad specs raise the same
  errors.
- A serve-side rule (``peer=serve``) answers its status on both serving
  backends, ``async`` (the reactor's inline query path included) and
  ``threaded``, with the reference's status, content type and body, and
  counts into ``pilosa_server_errors_total``; ``/debug/faults`` stays
  immune, and its GET and POST documents are the reference's.
- ``InternalClient`` surfaces an injected drop as a transport error (code
  None) and an injected error as its status, before any bytes leave.

Verdicts are discrete: exact agreement."""

import http.client
import json

import pytest

from pilosa_tpu import api as japi
from pilosa_tpu.net import faults as jfaults
from pilosa_tpu.net.client import ClientError as JClientError
from pilosa_tpu.net.client import InternalClient as JClient
from pilosa_tpu.net.server import serve as jserve
from pilosa_tpu_torch import api as tapi
from pilosa_tpu_torch.net import faults as tfaults
from pilosa_tpu_torch.net.client import ClientError as TClientError
from pilosa_tpu_torch.net.client import InternalClient as TClient
from pilosa_tpu_torch.net.server import serve as tserve
from pilosa_tpu_torch.util.stats import METRIC_SERVER_ERRORS, REGISTRY

MODS = (jfaults, tfaults)


@pytest.fixture(autouse=True)
def _healed():
    for mod in MODS:
        mod.PLANE.configure([], seed=0)
        mod.PLANE.set_local(set())
    yield
    for mod in MODS:
        mod.PLANE.configure([], seed=0)
        mod.PLANE.set_local(set())


SCHEDULE = [
    {"action": "drop", "peer": "127.0.0.1:10102", "route": "/index/*", "prob": 0.5},
    "error peer=* route=/internal/* status=502 prob=0.3 times=4",
    {"action": "delay", "peer": "localhost:10103", "ms": 0},
    "drop peer=127.0.0.1:1010? after=3 times=5",
    {"action": "partition", "a": ["n0", "127.0.0.1:10101"], "b": ["127.0.0.1:10104"]},
    "error peer=serve route=/index/*/query status=503 prob=0.5",
]

TRAFFIC = [
    ("127.0.0.1:10102", "/index/i/query", "http"),
    ("localhost:10102", "/internal/fragment/data", "http"),
    ("127.0.0.1:10105", "/status", "http"),
    ("localhost:10103", "/index/i/query", "http"),
    ("127.0.0.1:10104", "/status", "http"),
    ("127.0.0.1:10104", "gossip", "gossip"),
    ("127.0.0.1:10106", "/internal/translate/keys", "http"),
    ("serve", "/index/i/query", "serve"),
    ("serve", "/status", "serve"),
]


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_same_seed_same_verdicts(seed):
    runs = []
    for mod in MODS:
        mod.PLANE.set_local({"n0", "127.0.0.1:10101"})
        mod.PLANE.configure(SCHEDULE, seed=seed)
        verdicts = []
        for _ in range(12):
            for peer, route, transport in TRAFFIC:
                v = mod.PLANE.intercept(peer, route, transport=transport)
                verdicts.append(None if v is None else (v.action, v.status))
        runs.append((verdicts, mod.PLANE.snapshot()))
        # A re-install of the same schedule replays the same verdicts.
        mod.PLANE.configure(SCHEDULE, seed=seed)
        again = []
        for _ in range(12):
            for peer, route, transport in TRAFFIC:
                v = mod.PLANE.intercept(peer, route, transport=transport)
                again.append(None if v is None else (v.action, v.status))
        assert again == verdicts
    assert runs[1] == runs[0]
    assert any(v is not None for v in runs[1][0]) and None in runs[1][0]


@pytest.mark.parametrize("spec", [
    "explode peer=*", "drop per=a", "drop prob=2", "partition a=x", "drop peer", "",
    {"action": "drop", "ms": "x"}, {"peer": "*"}, 3,
])
def test_bad_specs_raise_as_the_reference(spec):
    errors = []
    for mod in MODS:
        with pytest.raises(ValueError) as e:
            mod.parse_rule(spec)
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def _send(port, method, path, body=b"", headers=None):
    c = http.client.HTTPConnection("localhost", port, timeout=30)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


@pytest.mark.parametrize("backend", ["async", "threaded"])
def test_serve_rules_answer_their_status(backend):
    apis = [japi.API(), tapi.API(device="cpu")]
    for a in apis:
        a.create_index("i")
        a.create_field("i", "f")
    servers = [jserve(apis[0], "localhost", 0, backend=backend)[0],
               tserve(apis[1], "localhost", 0, backend=backend)[0]]
    ports = [s.server_address[1] for s in servers]
    errors = REGISTRY.counter(METRIC_SERVER_ERRORS)
    try:
        body = json.dumps({"seed": 3, "rules": [
            "error peer=serve route=/index/*/query status=503",
            {"action": "error", "peer": "serve", "route": "/schema", "status": 502,
             "times": 1}]}).encode()
        posted = [json.loads(_send(p, "POST", "/debug/faults", body)[2]) for p in ports]
        assert posted[1] == posted[0] and len(posted[1]["rules"]) == 2
        e0 = errors.get()
        for path, method, payload in (("/index/i/query", "POST", b"Count(Row(f=1))"),
                                      ("/schema", "GET", b""),
                                      ("/schema", "GET", b""),
                                      ("/index/i/query", "POST", b"Row(f=1)")):
            got = [_send(p, method, path, payload) for p in ports]
            assert got[1] == got[0], (path, got)
        assert [g[0] for g in [_send(p, "POST", "/index/i/query", b"Count(Row(f=1))")
                               for p in ports]] == [503, 503]
        # Four injected answers of the port's node (the reference's count in
        # its own registry).
        assert errors.get() - e0 == 4
        # /debug/faults is immune to the rules it installs.
        got = [_send(p, "GET", "/debug/faults") for p in ports]
        assert got[0][0] == got[1][0] == 200
        assert json.loads(got[1][2]) == json.loads(got[0][2])
        healed = [_send(p, "POST", "/debug/faults", b'{"rules": []}') for p in ports]
        assert json.loads(healed[1][2]) == json.loads(healed[0][2])
        got = [_send(p, "POST", "/index/i/query", b"Count(Row(f=1))") for p in ports]
        assert [g[0] for g in got] == [200, 200]
        bad = [_send(p, "POST", "/debug/faults", b'{"rules": ["drop per=x"]}') for p in ports]
        assert bad[1][:2] == bad[0][:2] and bad[1][0] == 400
        assert json.loads(bad[1][2]) == json.loads(bad[0][2])
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        apis[1].close()


def test_client_intercept_before_any_bytes():
    """An unreachable peer still fails with the injected verdict first:
    no connection is attempted."""
    outcomes = []
    for mod, client_cls, err_cls in ((jfaults, JClient, JClientError),
                                     (tfaults, TClient, TClientError)):
        client = client_cls("http://127.0.0.1:9", timeout=1.0)
        got = []
        for rules in (["drop peer=127.0.0.1:9"], ["error peer=* route=/status status=504"],
                      [{"action": "partition", "a": ["me"], "b": ["localhost:9"]}]):
            mod.PLANE.set_local({"me"})
            mod.PLANE.configure(rules, seed=1)
            with pytest.raises(err_cls) as e:
                client.status()
            got.append((e.value.code, str(e.value)))
        outcomes.append((got, mod.PLANE.snapshot()["rules"][0]["injected"]))
    assert outcomes[1] == outcomes[0]
    assert [c for c, _ in outcomes[1][0]] == [None, 504, None]
