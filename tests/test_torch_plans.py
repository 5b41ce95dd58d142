"""The port's query plans (pilosa_tpu_torch.util.plans and the hooks in its
engine, batcher, fusion planner, executor, API and HTTP front end) against
the JAX package's, on the same seeded Holder.

The reference runs ``pilosa_tpu.api.API`` over a ``MeshEngine`` on one
mesh device; the port runs ``pilosa_tpu_torch.api.API(device="cpu")``.
Each query goes through both with ``profile=True`` and the two plans are
compared field by field:

- a dense Count, a sparse Count, a memo hit, a memo miss after a write
  (and its reason), two consecutive Counts in one query (one batch), a
  batched pair of Counts from two queries (riders of one drain), a fused
  drain (a Sum and a Count sharing a mask), TopN, Sum and GroupBy, and a
  Count over pool rows under a device budget;
- the analyzer's annotations (``analyze``), ``Explain(...)``, the
  ``/debug/plans`` and ``/debug/sequences`` documents, the tenant
  ledger's queries, bytes and sheds, and ``PILOSA_PLANS=0``.

What is left out of a comparison is timing, never a decision: the start
time, duration, stage and device seconds, trace ids, an op's ``seconds``
and the ``avgGapMs`` of a transition; and what those timings decide: the
two analyzer notes ("queue wait dominated", and the slow-TopN note that
a plan past 100 ms gets) and /debug/plans' retention of plans past 100
ms (``slow``).  The ops' ``touches`` (the working-set heat recorder's
input: the stacks, rows and occupied blocks each dispatch read) are
compared with the rest.  Ids, counts, bytes and plan fields are discrete:
exact agreement (tolerance 0)."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu import api as japi
from pilosa_tpu.net import server as jserver
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.parallel.batcher import CountBatcher as JBatcher
from pilosa_tpu.util import plan_miner as jminer
from pilosa_tpu.util import plans as jplans
from pilosa_tpu_torch import api as tapi
from pilosa_tpu_torch.net import server as tserver
from pilosa_tpu_torch.parallel.batcher import CountBatcher as TBatcher
from pilosa_tpu_torch.util import plan_miner as tminer
from pilosa_tpu_torch.util import plans as tplans

from test_torch_pool_aggregates import build_aggregates

SW = 1 << 20
N_SHARDS = 4
TIMING = ("startTime", "durationMs", "deviceSeconds", "stagesMs", "traceID")
TIMED_NOTES = ("queue wait dominated", "TopN: ranked cache")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(api, mod):
    """Index i over 4 shards: f, 4 rows spread over every block (dense);
    s, 3 rows whose bits sit in 2 of 64 blocks per shard (sparse); v, an
    int field 0..100; g, 3 rows for GroupBy."""
    from importlib import import_module

    FieldOptions = import_module(mod + ".core.field").FieldOptions
    rng = np.random.default_rng(7)
    idx = api.create_index("i")
    cols = rng.choice(N_SHARDS * SW, 60000, replace=False)
    idx.create_field("f").import_bulk(rng.integers(0, 4, len(cols)).tolist(), cols.tolist())
    rows, scols = [], []
    for r in range(3):
        for s in range(N_SHARDS):
            for b in (3 + r, 40):
                c = rng.choice(16384, 500, replace=False) + b * 16384 + s * SW
                rows += [r] * len(c)
                scols += c.tolist()
    idx.create_field("s").import_bulk(rows, scols)
    gcols = rng.choice(N_SHARDS * SW, 20000, replace=False)
    idx.create_field("g").import_bulk(rng.integers(0, 3, len(gcols)).tolist(), gcols.tolist())
    vcols = rng.choice(N_SHARDS * SW, 5000, replace=False)
    idx.create_field("v", FieldOptions(type="int", min=0, max=100)).import_values(
        vcols.tolist(), (vcols % 101).tolist())


def _apis():
    from pilosa_tpu.core.holder import Holder as JHolder

    jh = JHolder()
    jh.open()
    j = japi.API(holder=jh, mesh_engine=MeshEngine(jh, make_mesh(1)))
    t = tapi.API(device="cpu")
    _fill(j, "pilosa_tpu")
    _fill(t, "pilosa_tpu_torch")
    return j, t


@pytest.fixture(scope="module")
def apis():
    j, t = _apis()
    yield j, t
    t.close()


@pytest.fixture(autouse=True)
def _fresh_records():
    for mod in (jplans, tplans):
        mod.STORE.reset()
        mod.LEDGER.reset()
        # A dispatch note another test module's direct engine calls left on
        # this thread (no plan claims those) would merge into the next
        # plan's op.
        mod.take_dispatch_note()
    for mod in (jminer, tminer):
        mod.MINER.reset()
    yield


def _req(api, q, **kw):
    mod = tapi if isinstance(api, tapi.API) else japi
    kw.setdefault("profile", True)
    kw.setdefault("tenant", "t1")
    return mod.QueryRequest("i", q, **kw)


def norm_op(op, ref):
    d = dict(op)
    d.pop("seconds", None)
    return d


def norm_plan(plan, ref):
    """A plan dict without its timings (see the module docstring)."""
    d = {k: v for k, v in plan.items() if k not in TIMING}
    d["ops"] = [norm_op(o, ref) for o in plan["ops"]]
    d["annotations"] = [a for a in plan["annotations"] if not a.startswith(TIMED_NOTES)]
    return d


def both_plans(apis, q, **kw):
    """The same query through both APIs: (reference plan, port plan),
    each normalized, after checking the answers agree."""
    j, t = apis
    want = j.query(_req(j, q, **kw))
    got = t.query(_req(t, q, **kw))
    assert json.dumps(_plain(got.results)) == json.dumps(_plain(want.results))
    return norm_plan(want.plan, True), norm_plan(got.plan, False)


def _plain(res):
    if isinstance(res, list):
        return [_plain(r) for r in res]
    if hasattr(res, "columns"):
        return [int(c) for c in res.columns()]
    if hasattr(res, "to_dict"):
        return res.to_dict()
    if hasattr(res, "val"):
        return [res.val, res.count]
    if isinstance(res, tuple):
        return list(res)
    return res


def assert_same(apis, q, **kw):
    want, got = both_plans(apis, q, **kw)
    assert got == want
    return got


# -- one query, one plan ---------------------------------------------------------


@pytest.mark.parametrize("q, path", [
    ("Count(Intersect(Row(f=1), Row(f=2)))", "dense"),
    ("Count(Union(Row(s=0), Row(s=1)))", "sparse"),
    ("Count(Row(f=3))", "fast_cardinality"),
    ("Count(Difference(Row(f=0), Row(s=2)))", "dense"),
])
def test_count_plan_matches(apis, q, path):
    plan = assert_same(apis, q)
    assert plan["ops"][-1]["path"] == path
    if path == "sparse":
        assert plan["ops"][0]["blocks_surviving"] < plan["ops"][0]["blocks_total"]
        assert plan["annotations"][0].startswith("sparse path:")


def test_memo_hit_and_miss_after_write(apis):
    q = "Count(Intersect(Row(f=0), Row(g=1)))"
    first = assert_same(apis, q)
    assert first["ops"][0]["memo"] == "miss"
    hit = assert_same(apis, q)
    assert hit["ops"] == [{"op": "Count", "path": "memo", "memo": "hit"}]
    for api in apis:
        api.query(_req(api, "Set(77, f=0)", profile=False))
    after = assert_same(apis, q)
    assert after["ops"][0]["memo"] == "miss"
    assert after["ops"][0]["memo_reason"] == "version_token_advanced"
    assert "memo miss: version token advanced (write since last run)" in after["annotations"]


def test_consecutive_counts_one_batch(apis):
    plan = assert_same(
        apis, "Count(Intersect(Row(f=0), Row(f=1))) Count(Union(Row(f=2), Row(g=0)))"
        " Count(Row(g=2))")
    paths = [o["path"] for o in plan["ops"]]
    assert paths == ["fast_cardinality", "dense_batch", "dense_batch"]
    assert plan["ops"][1]["tier"] == 8 and plan["ops"][1]["cse_unique"] == 2


@pytest.mark.parametrize("q", ["Count(Range(v > 10))",
                               "Count(Intersect(Row(f=1), Range(v >< [5, 50])))"])
def test_range_count_operand_bytes_match(apis, q):
    """A lone Count with a range leaf: its predicate bits (uint32[depth],
    two for BETWEEN) among the operand bytes, as the reference's (the
    plans counted its planes before).  The rest of the op differs by
    design: the port's sparse planner reads a range leaf's occupancy (K2
    evaluates range leaves), the reference's sends it dense unplanned."""
    want, got = both_plans(apis, q)
    assert [o["bytes_touched"] for o in got["ops"]] == [o["bytes_touched"] for o in want["ops"]]
    assert got["bytesTouched"] == want["bytesTouched"]


@pytest.mark.parametrize("q", [
    "Count(Range(v > 10)) Count(Range(v < 40)) Count(Intersect(Row(f=1), Range(v >< [5, 50])))",
    "Count(Intersect(Row(f=0), Row(f=3))) Count(Union(Row(g=1), Range(v == 7)))"
    " Count(Union(Row(g=1), Range(v == 7)))",
])
def test_batch_with_range_leaves_plan_matches(apis, q):
    """A batch of Counts with range leaves is one K5 launch (no Count on
    K1 beside it), and its plan record, the range planes among its
    operand bytes, equals the reference's padded batch program's."""
    plan = assert_same(apis, q)
    ops = [o for o in plan["ops"] if o["path"] != "fast_cardinality"]
    assert {o["path"] for o in ops} == {"dense_batch"} and len(ops) == 3
    assert ops[0]["bytes_touched"] > 0 and ops[0]["tier"] == 8


@pytest.mark.parametrize("q", [
    "TopN(f, Row(g=1), n=2)",
    "TopN(f, n=3)",
    "Sum(Row(g=0), field=v)",
    "Min(Row(g=2), field=v)",
    "GroupBy(Rows(field=g), Rows(field=f))",
    "Row(f=1)",
])
def test_aggregate_plans_match(apis, q):
    assert_same(apis, q)


def test_explain_matches(apis):
    for q in ("Explain(Count(Intersect(Row(f=1), Row(f=3))))",
              "Explain(Count(Union(Row(s=0), Row(s=2))))",
              "Explain(Count(Row(f=1)))",
              "Explain(Count(Range(v > 50)))"):
        j, t = apis
        want = j.query(_req(j, q)).results
        got = t.query(_req(t, q)).results
        assert got == want


# -- riders of one drain -----------------------------------------------------------


def _held(eng, cls):
    """The engine's batcher with its workers held until ``release``: every
    submit queues, so one drain holds exactly the items queued before."""
    b = eng._batcher = cls(eng)
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


def _drain(api, eng, cls, async_qs, sync_qs=()):
    """Queue ``async_qs`` (query_async) and ``sync_qs`` (query, one thread
    each) into one held drain; the plans in submit order."""
    b, release = _held(eng, cls)
    futs = [api.query_async(_req(api, q)) for q in async_qs]
    assert all(f is not None for f in futs)
    out = {}

    def go(k, q):
        out[k] = api.query(_req(api, q))

    threads = [threading.Thread(target=go, args=(k, q)) for k, q in enumerate(sync_qs)]
    for th in threads:
        th.start()
    release(len(async_qs) + len(sync_qs))
    plans = []
    for f in futs:
        f.result(60)
        plans.append(f.query_plan)
    for th in threads:
        th.join(60)
        assert not th.is_alive()
    # The async plans are recorded by the futures' completion callbacks.
    deadline = time.monotonic() + 30
    while any(p.duration is None for p in plans) and time.monotonic() < deadline:
        time.sleep(0.005)
    b.stop()
    eng._batcher = None
    return [p.to_dict() for p in plans] + [out[k].plan for k in range(len(sync_qs))]


def _riders(apis, async_qs, sync_qs=()):
    j, t = apis
    want = _drain(j, j.mesh_engine, JBatcher, async_qs, sync_qs)
    got = _drain(t, t.engine, TBatcher, async_qs, sync_qs)
    want = [norm_plan(p, True) for p in want]
    got = [norm_plan(p, False) for p in got]
    assert got == want
    return got


def test_batched_pair_riders(apis):
    got = _riders(apis, ["Count(Intersect(Row(f=0), Row(f=2)))",
                         "Count(Intersect(Row(f=1), Row(f=3)))"])
    for plan in got:
        op, = plan["ops"]
        assert op["path"] == "dense_batch" and op["batch_size"] == 2


# Queries no other test asks (a result-memo hit answers at submit time and
# queues nothing).
@pytest.mark.parametrize("g, sync_qs", [
    (1, ["Sum(Row(g=1), field=v)"]),
    (2, ["Sum(Row(g=2), field=v)", "TopN(f, Row(g=2), n=2)", "Max(Row(g=2), field=v)",
         "GroupBy(Rows(field=f), filter=Row(g=2))"]),
])
def test_fused_drain_riders(apis, g, sync_qs):
    got = _riders(apis, [f"Count(Intersect(Row(g={g}), Row(f=2)))"], sync_qs)
    paths = [op["path"] for plan in got for op in plan["ops"] if "path" in op]
    assert paths == ["fused_program"] * (1 + len(sync_qs))
    # The aggregates' filter is a subtree of the Count's mask: one slot,
    # shared.
    assert got[0]["ops"][0]["mask_shared_with"] == 0
    assert all(p["ops"][0]["mask_shared_with"] == len(sync_qs) for p in got[1:])


# -- a Count over pool rows under a budget ----------------------------------------


def test_pool_count_plan_matches():
    from pilosa_tpu.core.holder import Holder as JHolder
    from pilosa_tpu_torch.core.holder import Holder as THolder
    from pilosa_tpu_torch.parallel.engine import TorchEngine

    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        h.open()
        build_aggregates(h)
    budget = 40 * 131088 + 4096
    je = MeshEngine(jh, make_mesh(1), max_resident_bytes=budget)
    te = TorchEngine(th, device="cpu", max_resident_bytes=budget)
    j = japi.API(holder=jh, mesh_engine=je)
    t = tapi.API(holder=th, engine=te)
    try:
        q = "Count(Intersect(Row(f=10), Row(f=11)))"
        cold = both_plans((j, t), q)
        assert cold[1] == cold[0]
        assert cold[1]["ops"][0]["path"] == "host_fallback"
        je.residency.flush(30)
        te.residency.flush(30)
        for p in both_plans((j, t), q + " "), both_plans((j, t), "Count(Difference(Row(f=11), Row(f=10)))"):
            assert p[1] == p[0]
            assert p[1]["ops"][0]["path"] == "dense"
        assert te.last_path == "dense" and te._stacks[("i", "f", "standard")].pool
    finally:
        te.close()


# -- the documents -------------------------------------------------------------------


def _get(handler, path, query=None):
    status, ctype, payload = handler.handle("GET", path, query or {}, b"", {})
    assert status == 200, payload
    return json.loads(payload)


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if k not in TIMING + ("seconds", "avgGapMs", "slow")}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def test_debug_plans_and_sequences_documents(apis):
    j, t = apis
    qs = ["Count(Intersect(Row(f=1), Row(f=2)))", "Sum(Row(g=0), field=v)",
          "Count(Intersect(Row(f=1), Row(f=2)))", "Count(Union(Row(s=0), Row(s=1)))",
          "Sum(Row(g=0), field=v)"]
    for api in (j, t):
        for q in qs:
            api.query(_req(api, q, profile=False))
    jh, th = jserver.Handler(j), tserver.Handler(t)
    for path, query in (("/debug/plans", {}), ("/debug/plans", {"op": ["Sum"]}),
                        ("/debug/plans", {"limit": ["2"]}), ("/debug/sequences", {}),
                        ("/debug/sequences", {"top": ["1"]})):
        want, got = _get(jh, path, query), _get(th, path, query)
        for doc in (want, got):
            for p in doc.get("recent", []):
                p["annotations"] = [a for a in p["annotations"]
                                    if not a.startswith(TIMED_NOTES)]
        assert _strip(got) == _strip(want), path
    seq = _get(th, "/debug/sequences")
    assert seq["observed"] == len(qs) and seq["edgesObserved"] == len(qs) - 1


def test_tenant_ledger_queries_and_sheds(apis):
    j, t = apis
    for api in (j, t):
        for q, tenant in (("Count(Intersect(Row(f=1), Row(g=2)))", "a"),
                          ("Count(Union(Row(s=1), Row(s=2)))", "b"),
                          ("Count(Row(f=2))", "a")):
            api.query(_req(api, q, tenant=tenant, profile=False))
    for mod in (jplans, tplans):
        mod.LEDGER.note_shed("b")
        mod.LEDGER.account_queries("c", 3)

    def cols(snap):
        return {k: {c: v for c, v in r.items() if c != "deviceSeconds"} for k, r in snap.items()}

    want, got = jplans.LEDGER.snapshot(), tplans.LEDGER.snapshot()
    assert cols(got) == cols(want)
    assert got["b"]["sheds"] == 1 and got["a"]["queries"] == 2 and got["c"]["queries"] == 3
    assert got["b"]["bytesSkipped"] > 0


def test_shed_through_the_reactor_reaches_the_ledger(apis):
    """A request the admission controller sheds on the reactor is charged
    to its tenant's ledger row in both packages."""
    import http.client

    from pilosa_tpu.net.admission import AdmissionController as JAdm
    from pilosa_tpu_torch.net.admission import AdmissionController as TAdm

    j, t = apis
    sheds = []
    for api, serve, adm_cls, mod in ((j, jserver.serve, JAdm, jplans),
                                     (t, tserver.serve, TAdm, tplans)):
        adm = adm_cls(max_inflight=1)
        srv, _ = serve(api, "localhost", 0, admission=adm)
        try:
            for k in range(adm.hard_limit):
                assert adm.admit(f"hold{k}") is None  # every slot, held
            c = http.client.HTTPConnection("localhost", srv.server_address[1], timeout=30)
            c.request("POST", "/index/i/query", body="Count(Row(f=1))",
                      headers={"X-Pilosa-Tenant": "z"})
            r = c.getresponse()
            r.read()
            c.close()
            for k in range(adm.hard_limit):
                adm.release(f"hold{k}")
            sheds.append((r.status, mod.LEDGER.snapshot()["z"]["sheds"]))
        finally:
            srv.shutdown()
            srv.server_close()
    assert sheds[0] == sheds[1] and sheds[1][0] in (429, 503) and sheds[1][1] == 1


def test_plans_disabled(apis, monkeypatch):
    """``PILOSA_PLANS=0`` turns the layer off in both packages: no plan
    inline, none recorded, nothing in the ledger."""
    j, t = apis
    for mod in (jplans, tplans):
        monkeypatch.setattr(mod, "ENABLED", False)
    for api, mod in ((j, jplans), (t, tplans)):
        resp = api.query(_req(api, "Count(Intersect(Row(f=1), Row(f=0)))"))
        assert resp.plan is None
        assert mod.STORE.recorded == 0 and mod.LEDGER.snapshot() == {}
    env = dict(os.environ, PILOSA_PLANS="0", JAX_PLATFORMS="cpu")
    code = ("import pilosa_tpu.util.plans as a, pilosa_tpu_torch.util.plans as b; "
            "print(a.ENABLED, b.ENABLED, b.begin('i', 'q') is None)")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.split() == ["False", "False", "True"], out.stderr


def test_analyze_matches_on_synthetic_plans():
    """``analyze`` gives the reference's notes for every branch, the slow
    TopN note included."""
    ops = [
        {"op": "Count", "path": "dense", "occ_fraction": 0.92, "threshold": 0.25},
        {"op": "Count", "path": "sparse", "blocks_surviving": 3, "blocks_total": 64,
         "bytes_skipped": 1000},
        {"op": "Count", "path": "host_fallback", "stack": "i/f/standard",
         "resident_fraction": 0.5},
        {"op": "Count", "memo": "miss", "memo_reason": "evicted"},
        {"op": "Count", "cse_deduped": 2, "cse_unique": 1},
        {"op": "Sum", "path": "fused_program", "mask_shared_with": 2, "masks_evaluated": 2,
         "masks_referenced": 5, "crossIndex": True, "fused_indexes": 2, "fusedGroupBy": 4},
        {"op": "TopN", "topkDevice": 5},
        {"op": "TopN", "path": "host_merge", "candidates": 7},
        {"op": "Count", "last_resort": True}, {"op": "Set", "hinted": 2},
    ]
    for slow in (False, True):
        notes = []
        for mod in (jplans, tplans):
            p = mod.QueryPlan("i", "TopN(f)", tenant="x")
            for o in ops:
                p.note_op(**o)
            p.note_fanout("n2", 0.01, 3)
            p.note_stage("queue_wait", 0.9)
            p.finish(1.0)
            notes.append(mod.analyze(p, slow=slow))
        assert notes[1] == notes[0]
