"""Working-set heat, the sequence miner's ``predict_next`` and the prefetch
advisor in the port (``pilosa_tpu_torch/util/heat.py``,
``util/plan_miner.py``, ``parallel/advisor.py`` and the engine's touches)
against the JAX package's, on the same seeded data.

The reference runs ``pilosa_tpu.api.API`` over a ``MeshEngine`` on one mesh
device; the port runs ``pilosa_tpu_torch.api.API`` over a
``TorchEngine(device="cpu")``.  The same queries go through both in the same
order, with every process-wide singleton of both packages (``HEAT``,
``MINER``, ``ADVISOR``, the plan ``STORE`` and ``LEDGER``) reset around each
case, and these must be equal:

- each plan op's ``touches`` (stack, rows, occupied-block count and mask);
- ``HEAT.to_doc`` (every table, its ranked rows and blocks, the resident
  split and the gap) and ``HEAT.totals``, with ``bytesAccounted`` equal to
  the tenant ledger's bytes for the same traffic;
- ``MINER.predict_next`` of every signature, and ``ADVISOR.to_doc`` (the
  outstanding hints, the counts and ``hitRate``);
- under a device budget that holds one working set, the engine journal's
  promotions by cause (``reactive`` and ``advisor``), the host fallbacks and
  every answer, with promote-ahead driving the advisor's hints into
  residency;
- ``GET /debug/heat`` and ``GET /debug/prefetch_advice``.

The EWMAs are the same float operations in the same order on both sides:
exact agreement (tolerance 0)."""

import gc
import json

import numpy as np
import pytest
import torch

from pilosa_tpu import api as japi
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.net import server as jserver
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.parallel import advisor as jadvisor
from pilosa_tpu.util import heat as jheat
from pilosa_tpu.util import plan_miner as jminer
from pilosa_tpu.util import plans as jplans
from pilosa_tpu.util.events import EventJournal as JJournal
from pilosa_tpu_torch import api as tapi
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.net import server as tserver
from pilosa_tpu_torch.parallel import advisor as tadvisor
from pilosa_tpu_torch.parallel.engine import TorchEngine
from pilosa_tpu_torch.util import heat as theat
from pilosa_tpu_torch.util import plan_miner as tminer
from pilosa_tpu_torch.util import plans as tplans
from pilosa_tpu_torch.util.events import EventJournal as TJournal

SW = 1 << 20
BLOCK_BITS = 16384  # one 2 KiB occupancy block
ROW_SHARD = 32768 * 4 + 16
N_SHARDS = 4

DASH_A = "Count(Intersect(Row(f=0), Row(f=1)))"
DASH_B = "Count(Intersect(Row(f=8), Row(f=9)))"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset_all():
    for mod in (jheat, theat):
        mod.HEAT.reset()
    for mod in (jminer, tminer):
        mod.MINER.reset()
    for mod in (jadvisor, tadvisor):
        mod.ADVISOR.reset()
        mod.ADVISOR.drive_promotions = True
    for mod in (jplans, tplans):
        mod.STORE.reset()
        mod.LEDGER.reset()
        mod.take_dispatch_note()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Fresh singletons, and a sequence window no stall can break: each
    package's miner times its own queries, and between two of them lies
    the other package's query (a JAX compile on the reference's side can
    take seconds on a loaded host), so the reference's 5 s window would
    make the two transition tables differ by timing alone."""
    windows = [mod.MINER.window_s for mod in (jminer, tminer)]
    for mod in (jminer, tminer):
        mod.MINER.window_s = 3600.0
    _reset_all()
    yield
    _reset_all()
    for mod, w in zip((jminer, tminer), windows):
        mod.MINER.window_s = w


def _fill(holder):
    """Index i over N_SHARDS shards: f's rows 0, 1, 8, 9 and 5, each in a
    few occupancy blocks of every shard (row r in blocks r % 7 and
    (3 r) % 11); g, 3 rows spread everywhere."""
    rng = np.random.default_rng(11)
    idx = holder.create_index("i")
    rows, cols = [], []
    for s in range(N_SHARDS):
        for r in (0, 1, 5, 8, 9):
            for b in {r % 7, (3 * r) % 11}:
                c = rng.choice(BLOCK_BITS, 40, replace=False) + b * BLOCK_BITS + s * SW
                rows += [r] * len(c)
                cols += c.tolist()
    idx.create_field("f").import_bulk(rows, cols)
    gcols = rng.choice(N_SHARDS * SW, 4000, replace=False)
    idx.create_field("g").import_bulk(rng.integers(0, 3, len(gcols)).tolist(), gcols.tolist())


def _apis(budget=None, n_rows=None):
    """Reference and port APIs over equal data.  With ``budget`` both
    engines get that device budget, their own journal and no result memo,
    over ``n_rows`` rows of f and of h on one shard (stacks the budget
    cannot hold whole)."""
    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        h.open()
        if budget is None:
            _fill(h)
        else:
            idx = h.create_index("i")
            rows, cols = [], []
            for r in range(n_rows):
                for c in range(0, 400 + 10 * r, 2):
                    rows.append(r)
                    cols.append(c + (r % 8) * BLOCK_BITS)
            for name in ("f", "h"):
                idx.create_field(name).import_bulk(rows, cols)
    kw = {} if budget is None else {"max_resident_bytes": budget}
    je = MeshEngine(jh, make_mesh(1), journal=JJournal(), **kw)
    te = TorchEngine(th, device="cpu", journal=TJournal(), **kw)
    if budget is not None:
        je.result_memo.maxsize = te.result_memo.maxsize = 0
    return japi.API(holder=jh, mesh_engine=je), tapi.API(holder=th, engine=te)


def _q(api, q, tenant="t1", profile=False):
    mod = tapi if isinstance(api, tapi.API) else japi
    return api.query(mod.QueryRequest("i", q, tenant=tenant, profile=profile))


def _plain(res):
    out = []
    for r in res:
        if hasattr(r, "columns"):
            out.append([int(c) for c in r.columns()])
        elif isinstance(r, list):
            out.append([x.to_dict() if hasattr(x, "to_dict") else x for x in r])
        elif hasattr(r, "val"):
            out.append([r.val, r.count])
        else:
            out.append(r)
    return out


def both(apis, q, **kw):
    j, t = apis
    want = _q(j, q, **kw)
    got = _q(t, q, **kw)
    assert json.dumps(_plain(got.results), default=str) == json.dumps(
        _plain(want.results), default=str), q
    return want, got


@pytest.fixture(scope="module")
def _module_apis():
    j, t = _apis()
    yield j, t
    t.close()
    j.mesh_engine.close()


@pytest.fixture
def apis(_module_apis):
    """The module's two APIs, with both packages' heat recorder and advisor
    bound to their engines (the last engine made binds them, and other
    cases make engines of their own)."""
    j, t = _module_apis
    for heat_mod, adv_mod, eng in ((jheat, jadvisor, j.mesh_engine),
                                   (theat, tadvisor, t.engine)):
        heat_mod.HEAT.bind_engine(eng)
        adv_mod.ADVISOR.bind_engine(eng)
    return j, t


# -- touches ----------------------------------------------------------------------


@pytest.mark.parametrize("q", [
    DASH_A,
    "Count(Union(Row(f=5), Row(f=8)))",
    "Count(Difference(Row(f=9), Row(g=1)))",
    "Count(Intersect(Row(f=0), Row(f=1))) Count(Union(Row(f=8), Row(g=2)))",
])
def test_touches_match(apis, q):
    """Every op's touches (stack, sorted rows, exact occupied-block count and
    the OR of the rows' occupancy masks) equal the reference's."""
    want, got = both(apis, q, profile=True)
    wt = [o.get("touches") for o in want.plan["ops"]]
    gt = [o.get("touches") for o in got.plan["ops"]]
    assert gt == wt
    assert any(t for t in wt), want.plan["ops"]


def test_host_fallback_touches_match():
    """A miss served from the host lane is a touch with no bytes, rows and
    no blocks, on both sides."""
    apis = _apis(budget=2 * ROW_SHARD + 4096, n_rows=16)
    try:
        want, got = both(apis, "Count(Intersect(Row(f=10), Row(f=11)))", profile=True)
        wt = [o.get("touches") for o in want.plan["ops"] if o.get("path") == "host_fallback"]
        gt = [o.get("touches") for o in got.plan["ops"] if o.get("path") == "host_fallback"]
        assert wt and gt == wt == [[("i", "f", "standard", (10, 11), 0, 0)]]
    finally:
        apis[1].close()
        apis[0].mesh_engine.close()


# -- heat tables --------------------------------------------------------------------


def _traffic(apis, cycles=4):
    # A fresh recorder holds no memo touches to replay: start from misses
    # (each package's repair layer serves repeats as memo hits too).
    apis[0].mesh_engine.result_memo.clear()
    apis[0].mesh_engine.repairs.clear()
    apis[1].engine.result_memo.clear()
    apis[1].engine.repairs.clear()
    for _ in range(cycles):
        both(apis, DASH_A)
        both(apis, DASH_B)
    both(apis, "Count(Union(Row(f=5), Row(g=0)))")


@pytest.mark.parametrize("index,field,topk", [("", "", 10), ("i", "f", 3), ("i", "g", 1)])
def test_heat_doc_and_totals_match(apis, index, field, topk):
    _traffic(apis)
    jd = jheat.HEAT.to_doc(index=index, field=field, topk=topk)
    td = theat.HEAT.to_doc(index=index, field=field, topk=topk)
    assert td == jd
    assert jd["tables"]
    jt, tt = jheat.HEAT.totals(), theat.HEAT.totals()
    assert tt == jt
    # The drift-free contract: heat's bytes are the ledger's bytes.
    ledger = tplans.LEDGER.snapshot()["t1"]["bytesTouched"]
    assert tt["bytesAccounted"] == ledger == jplans.LEDGER.snapshot()["t1"]["bytesTouched"]
    assert tt["bytesAccounted"] == tt["tableBytes"] + tt["untrackedBytes"]
    assert theat.HEAT.refresh_gauges() == jheat.HEAT.refresh_gauges()


def test_memo_replay_and_system_index_match(apis):
    """A memo hit replays its first dispatch's touches byte-free, and a
    ``_system`` plan stays out of the tables, on both sides."""
    both(apis, DASH_A)
    both(apis, DASH_A)  # a memo hit
    for mod in (jplans, tplans):
        p = mod.begin("_system", "Count(Row(f=1))")
        p.note_op(op="Count", path="dense", bytes_touched=100)
        p.finish(0.01)
        mod.record(p)
    assert theat.HEAT.totals() == jheat.HEAT.totals()
    assert theat.HEAT.totals()["plansObserved"] == 2
    assert theat.HEAT.to_doc() == jheat.HEAT.to_doc()


# -- the miner and the advisor --------------------------------------------------------


def test_predict_next_and_advisor_match(apis):
    _traffic(apis, cycles=3)
    both(apis, DASH_A)
    jsigs = [t["signature"] for t in jminer.MINER.to_doc()["transitions"]]
    tsigs = [t["signature"] for t in tminer.MINER.to_doc()["transitions"]]
    assert tsigs == jsigs and len(jsigs) >= 2
    for sig in jsigs + ["i|never"]:
        assert tminer.MINER.predict_next(sig) == jminer.MINER.predict_next(sig)
    jd, td = jadvisor.ADVISOR.to_doc(), tadvisor.ADVISOR.to_doc()
    assert td == jd
    assert jd["outstanding"]["hints"][0]["rows"] == [8, 9]
    assert jd["hitRate"] >= 0.7 and jd["drivesPromotions"] is True


def test_debug_heat_and_advice_routes_match(apis):
    _traffic(apis, cycles=2)
    hs = [jserver.Handler(apis[0]), tserver.Handler(apis[1])]
    for path, query in (("/debug/heat", {"index": ["i"], "topk": ["4"]}),
                        ("/debug/heat", {}),
                        ("/debug/prefetch_advice", {})):
        got = [h.handle("GET", path, query, b"", {}) for h in hs]
        assert got[0][:2] == got[1][:2] == (200, "application/json")
        assert json.loads(got[1][2]) == json.loads(got[0][2])
    bad = [h.handle("GET", "/debug/heat", {"topk": ["abc"]}, b"", {}) for h in hs]
    assert bad[0][0] == bad[1][0] == 400


# -- promote-ahead under a budget ----------------------------------------------------------


def _promotions(journal):
    by = {}
    for e in journal.events(type="engine.promotion"):
        c = e.fields.get("cause")
        by[c] = by.get(c, 0) + 1
    return by


def test_promote_ahead_matches_under_a_budget():
    """Two single-query dashboards over disjoint fields alternate under a
    budget that holds one dashboard's block pool at a time: the advisor learns the
    alternation and pushes the other dashboard's rows into residency
    ahead of it.  Promotions by cause, host fallbacks, the advisor's
    document and every answer equal the reference's, and promote-ahead
    leaves the later arrivals with no host fallback."""
    apis = _apis(budget=24 * 1024, n_rows=16)
    j, t = apis
    engines = (j.mesh_engine, t.engine)
    try:
        # The advisor reads residency after each query; the demand
        # promotion that query's miss queued races it on the residency
        # worker.  Landing it first (the worker wins, as on an idle host)
        # keeps both packages on one order on a loaded one.
        for e in engines:
            def split(key, rows, e=e, orig=e.residency_row_split):
                assert e.residency.flush(30.0)
                return orig(key, rows)

            e.residency_row_split = split
        qa = "Count(Intersect(Row(f=2), Row(f=3)))"
        qb = "Count(Intersect(Row(h=12), Row(h=13)))"
        fallbacks = []
        for k in range(10):
            both(apis, qa if k % 2 == 0 else qb)
            for e in engines:
                assert e.residency.flush(30.0)
            # An evicted stack's buffer counts against the budget until it
            # is freed; the port collects garbage once before it refuses a
            # promotion, the reference does not, so collect here and both
            # see the same free bytes.
            gc.collect()
            fallbacks.append(tuple(e.host_fallbacks for e in engines))
        assert [f[1] for f in fallbacks] == [f[0] for f in fallbacks]
        jp, tp = _promotions(engines[0].journal), _promotions(engines[1].journal)
        assert tp == jp
        assert tp.get("advisor", 0) > 0
        jd, td = jadvisor.ADVISOR.to_doc(), tadvisor.ADVISOR.to_doc()
        assert td == jd and td["drivenRequests"] > 0
        # Once the alternation is learned each arrival finds its rows
        # promoted ahead: the last cycles add no fallback.
        assert fallbacks[-1][1] == fallbacks[-3][1]
        assert (engines[1].residency.snapshot()["advisorDeferred"]
                == engines[0].residency.snapshot()["advisorDeferred"])
    finally:
        t.close()
        j.mesh_engine.close()
