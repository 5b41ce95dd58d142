"""The self-hosted metrics history and the SLO watcher in the port
(``pilosa_tpu_torch/util/history.py``, ``util/slo.py``) against the JAX
package's, on a synthetic clock.

Both packages' samplers read the same registry snapshots (``snapshot_fn``)
at the same instants (``now``), each writing into its own API's ``_system``
index: the reference's ``API`` over a ``MeshEngine`` on one mesh device and
the port's ``API(device="cpu")``.  These must be equal:

- ``query`` (every series, with ``since``/``until``/``step``/``label``),
  ``window``, ``series_names`` and ``snapshot``;
- retention: the hour views dropped once their hour ages past the
  retention, and the points that vanish with them;
- the PQL read ``Sum(Range(samples=<sid>, S, E), field=<family>)`` over
  ``_system``, which also equals the sum of ``query``'s points, and its
  plan (the engine's lowering, not a host fallback);
- the SLO watcher's burn and clear edges (the journal's ``slo.burn`` and
  ``slo.clear``), the ``degraded`` reasons, the flight-recorder bundle's
  keys and the pruning of the persisted bundles.

Values are fixed-point integers: exact agreement (tolerance 0)."""

import datetime as dt
import json
import os

import pytest

from pilosa_tpu import api as japi
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.util import heat as jheat
from pilosa_tpu.util import history as jhistory
from pilosa_tpu.util import plans as jplans
from pilosa_tpu.util import slo as jslo
from pilosa_tpu.util.events import EventJournal as JJournal
from pilosa_tpu_torch import api as tapi
from pilosa_tpu_torch.util import heat as theat
from pilosa_tpu_torch.util import history as thistory
from pilosa_tpu_torch.util import plans as tplans
from pilosa_tpu_torch.util import slo as tslo
from pilosa_tpu_torch.util.events import EventJournal as TJournal

T0 = 1_700_000_000.0


def _apis():
    jh = JHolder()
    jh.open()
    j = japi.API(holder=jh, mesh_engine=MeshEngine(jh, make_mesh(1)), journal=JJournal())
    t = tapi.API(device="cpu", journal=TJournal())
    return j, t


class Feed:
    """Registry snapshots in ``MetricsRegistry.snapshot()`` shape: counters
    that grow by ``errors``/``requests`` per call, a gauge, a histogram."""

    def __init__(self):
        self.k = 0
        self.errors = 0.0
        self.requests = 0.0
        self.err_step = 0.0
        self.req_step = 10.0

    def __call__(self):
        self.k += 1
        self.errors += self.err_step
        self.requests += self.req_step
        return {
            "counters": {
                "pilosa_server_errors_total": {"_": self.errors},
                "pilosa_server_requests_total": {"path=inline": self.requests * 0.75,
                                                 "path=pool": self.requests * 0.25},
                "pilosa_ingest_bits_total": {"path=system": 5.0 * self.k,
                                             "path=bits": 3.0 * self.k},
            },
            "gauges": {"pilosa_engine_residency_gap_bytes": {"_": 4096.0 * (self.k % 5)},
                       "pilosa_engine_heat_tracked_rows": {"_": float(self.k)}},
            "histograms": {"pilosa_query_seconds": {
                "path=sync": {"count": 3 * self.k, "p50": 0.0005 * self.k,
                              "p95": 0.002 + 0.0001 * self.k}}},
        }


def _samplers(apis, interval=1.0, retention=3600.0):
    """One sampler per package over the same feed: the feed answers each
    snapshot once and both samplers read that answer."""
    feed = Feed()
    cache = {}

    def snap_for(side):
        def fn():
            n = cache.setdefault(side, 0)
            cache[side] = n + 1
            key = ("snap", n)
            if key not in cache:
                cache[key] = feed()
            return json.loads(json.dumps(cache[key]))
        return fn

    mods = (jhistory, thistory)
    hs = [mod.HistorySampler(api, node="n1", interval=interval, retention=retention,
                             snapshot_fn=snap_for(k), now_fn=lambda: T0)
          for k, (mod, api) in enumerate(zip(mods, apis))]
    return feed, hs


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (jplans, tplans):
        mod.STORE.reset()
        mod.take_dispatch_note()
    for mod in (jheat, theat):
        mod.HEAT.reset()
    yield


def _tick(hs, now):
    return [h.tick(now=now) for h in hs]


def test_points_window_names_and_snapshot_match():
    apis = _apis()
    _feed, hs = _samplers(apis)
    for i in range(8):
        stored = _tick(hs, T0 + i)
        assert stored[1] == stored[0] > 0
    assert hs[1].series_names() == hs[0].series_names()
    assert "pilosa_ingest_bits_total_rate" in hs[1].series_names()
    for fam in hs[0].series_names():
        for kw in ({"since": T0 - 10, "until": T0 + 10},
                   {"since": T0 + 2, "until": T0 + 6, "step": 2.0},
                   {"since": T0, "until": T0 + 7, "label": "path=inline"}):
            assert hs[1].query(fam, **kw) == hs[0].query(fam, **kw), (fam, kw)
    # The sampler's own writes (path=system) are never sampled.
    pts = hs[1].query("pilosa_ingest_bits_total_rate", since=T0, until=T0 + 8)["points"]
    assert "path=system" not in pts and pts["path=bits"]
    assert hs[1].window(5.0, until=T0 + 7) == hs[0].window(5.0, until=T0 + 7)
    assert hs[1].snapshot() == hs[0].snapshot()
    gap = hs[1].query("pilosa_engine_residency_gap_bytes", since=T0, until=T0 + 8)
    assert [v for _, v in gap["points"]["_"]] == [4096000 * (k % 5) for k in range(1, 9)]
    apis[1].close()


def test_retention_drops_hour_views():
    """Hour views whose whole hour has aged past the retention are
    dropped, with their points, on both sides."""
    apis = _apis()
    _feed, hs = _samplers(apis, interval=60.0, retention=3600.0)
    for i in range(16):
        _tick(hs, T0 + 1200.0 * i)
        assert hs[1].snapshot() == hs[0].snapshot()
    views = hs[1].snapshot()["hourViews"]
    assert 1 <= len(views) <= 3
    for fam in ("pilosa_engine_heat_tracked_rows", "pilosa_server_requests_total_rate"):
        for since in (T0 - 60, T0 + 9000, T0 + 15000):
            kw = {"since": since, "until": T0 + 18000}
            assert hs[1].query(fam, **kw) == hs[0].query(fam, **kw)
    old = hs[1].query("pilosa_engine_heat_tracked_rows", since=T0 - 60, until=T0 + 3600)
    assert old["points"]["_"] == []
    apis[1].close()


def _hour(ts):
    return dt.datetime.fromtimestamp(ts, dt.timezone.utc).strftime("%Y-%m-%dT%H:%M")


@pytest.mark.parametrize("family", ["pilosa_engine_residency_gap_bytes",
                                    "pilosa_query_seconds_p95_us"])
def test_pql_sum_over_system_matches(family):
    """``Sum(Range(samples=<sid>, S, E), field=<family>)`` over the middle
    of three live hour views answers the same in both packages, equals the
    sum of ``query``'s points over that hour (and not over all three), and
    plans the same (the engine's lowering of the hour view's time cover as
    the Sum's filter)."""
    apis = _apis()
    _feed, hs = _samplers(apis, interval=60.0, retention=3 * 3600.0)
    h0 = T0 // 3600 * 3600
    for h, n in enumerate((3, 5, 2)):  # a different number of ticks in each hour
        for k in range(n):
            _tick(hs, h0 + h * 3600 + 600 + 60 * k)
    assert len(hs[1].snapshot()["hourViews"]) == 3
    sid = hs[1]._series[family][
        "_" if family.startswith("pilosa_engine") else "path=sync"]
    assert hs[0]._series[family] == hs[1]._series[family]
    lo, hi = h0 + 3600, h0 + 2 * 3600  # the middle hour; Range's end is exclusive
    q = f"Sum(Range(samples={sid}, {_hour(lo)}, {_hour(hi)}), field={family})"
    got = []
    for api, mod in zip(apis, (japi, tapi)):
        resp = api.query(mod.QueryRequest("_system", q, profile=True))
        r = resp.results[0]
        got.append(((r.val, r.count), [o.get("path") for o in resp.plan["ops"]]))
    assert got[1] == got[0]

    def points(since, until):
        pts = hs[1].query(family, since=since, until=until)["points"]
        return [p for series in pts.values() for p in series]

    want, every = points(lo, hi - 60), points(h0, h0 + 3 * 3600)
    assert want and len(want) < len(every)
    assert got[1][0] == (sum(v for _, v in want), len(want))
    assert got[1][0] != (sum(v for _, v in every), len(every))
    assert "host_fallback" not in got[1][1]
    apis[1].close()


# -- the SLO watcher -------------------------------------------------------------


def _watchers(apis, hs, tmp_path):
    return [mod.SLOWatcher(api, h, node="n1", error_rate_target=0.01, window=4.0,
                           burn_threshold=2.0, data_dir=str(tmp_path / name),
                           max_bundles=2, now_fn=lambda: T0)
            for mod, api, h, name in zip((jslo, tslo), apis, hs, ("ref", "port"))]


def test_slo_edges_degraded_bundles_and_pruning(tmp_path):
    apis = _apis()
    feed, hs = _samplers(apis)
    ws = _watchers(apis, hs, tmp_path)
    now = T0
    degraded = []
    # Three burns, each cleared: 5% errors for 4 ticks, then none for 6.
    for cycle in range(3):
        for step, err in [(k, 0.5) for k in range(4)] + [(k, 0.0) for k in range(6)]:
            feed.err_step = err
            _tick(hs, now)
            evals = [w.tick(now=now) for w in ws]
            assert evals[1] == evals[0]
            degraded.append([w.degraded for w in ws])
            now += 1.0
    assert all(d[1] == d[0] for d in degraded)
    assert ["slo:error_rate"] in [d[1] for d in degraded] and [] in [d[1] for d in degraded]
    edges = [[(e.type, e.fields.get("slo")) for e in api.journal.events(type="slo")]
             for api in apis]
    assert edges[1] == edges[0]
    assert edges[1] == [("slo.burn", "error_rate"), ("slo.clear", "error_rate")] * 3
    snaps = [w.snapshot() for w in ws]
    for s in snaps:
        s.pop("lastTickTs")
    assert snaps[1] == snaps[0] and snaps[1]["bundlesWritten"] == 3
    # Persisted bundles are pruned to max_bundles, newest kept.
    paths = [w.bundle_paths() for w in ws]
    assert [os.path.basename(p) for p in paths[1]] == [os.path.basename(p) for p in paths[0]]
    assert len(paths[1]) == 2
    bundles = [json.load(open(p[-1])) for p in paths]
    assert set(bundles[1]) == set(bundles[0])
    assert bundles[1]["reason"] == "error_rate" and bundles[1]["history"]
    assert set(bundles[1]["history"]) == set(bundles[0]["history"])
    live = [w.flight_bundle(now=now) for w in ws]
    assert set(live[1]) == set(live[0]) and live[1]["reason"] == "manual"
    apis[1].close()


def test_latency_objective_matches(tmp_path):
    """The latency objective reads the stored p95 quantile as the reference
    does (its value is the stored integer over ``scale`` and 1000)."""
    apis = _apis()
    _feed, hs = _samplers(apis)
    ws = [mod.SLOWatcher(api, h, latency_p95_ms_target=0.001, window=3.0, now_fn=lambda: T0)
          for mod, api, h in zip((jslo, tslo), apis, hs)]
    for i in range(5):
        _tick(hs, T0 + i)
        evals = [w.tick(now=T0 + i) for w in ws]
        assert evals[1] == evals[0]
    assert ws[1].degraded == ws[0].degraded == ["slo:latency_p95_ms"]
    apis[1].close()
