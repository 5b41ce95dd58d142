"""Time-quantum ``Range`` in the port against the JAX package, on one seeded
index built in both packages from the same numpy data: ``Count(Range(t=r,
start, end))`` through the port's ``Executor`` with its ``TorchEngine``
(the OR of one row leaf per view of the minimal cover, on K1, K2 or K5)
and without one (the host lane), against the JAX executor through its
``MeshEngine`` and on its host path.  Counts are integers: exact
agreement (tolerance 0).

Field ``t`` has quantum YMD, rows 7 and 8 written with timestamps from
2017 to 2019 (year, month and day views); ``h`` has quantum YMDH, so a
long span's cover is past the kernels' 32-leaf table and takes the host
lane; ``g`` is a set field; ``s`` has no time quantum."""

import datetime as dt

import numpy as np
import pytest

from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.core import timequantum
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.parallel import kernels
from pilosa_tpu_torch.parallel.engine import TorchEngine

N_SHARDS = 3
SW = bitops.SHARD_WIDTH
T0 = dt.datetime(2017, 1, 1)
SPAN_HOURS = 3 * 365 * 24
H0 = dt.datetime(2018, 2, 3)  # field h: two days of hour views


def seeded_data(seed=17):
    """{field: (rows, cols, timestamps or None)}."""
    rng = np.random.default_rng(seed)
    data = {}
    for name, rows, per, t0, span in (("t", (7, 8), 4000, T0, SPAN_HOURS),
                                      ("h", (1,), 600, H0, 48)):
        rs, cs, ts = [], [], []
        for r in rows:
            for s in range(N_SHARDS):
                cols = s * SW + rng.choice(SW, per, replace=False)
                hours = rng.integers(0, span, per)
                rs += [r] * per
                cs += cols.tolist()
                ts += [t0 + dt.timedelta(hours=int(x)) for x in hours]
        data[name] = (rs, cs, ts)
    rs, cs = [], []
    for s in range(N_SHARDS):
        cols = s * SW + rng.choice(SW, 30000, replace=False)
        rs += [1] * cols.size
        cs += cols.tolist()
    data["g"] = (rs, cs, None)
    data["s"] = ([7] * 100, rng.choice(N_SHARDS * SW, 100, replace=False).tolist(), None)
    return data


def fill(holder, data, FieldOptions):
    idx = holder.create_index("i")
    quanta = {"t": "YMD", "h": "YMDH"}
    for name, (rows, cols, ts) in data.items():
        opts = FieldOptions(type="time", time_quantum=quanta[name]) if name in quanta else None
        idx.create_field(name, opts).import_bulk(rows, cols, timestamps=ts)
    return holder


@pytest.fixture(scope="module")
def execs():
    data = seeded_data()
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    fill(jh, data, JFieldOptions)
    fill(th, data, TFieldOptions)
    return {
        "jfused": JExecutor(jh, mesh_engine=MeshEngine(jh, make_mesh(8))),
        "jhost": JExecutor(jh),
        "port": Executor(th, engine=TorchEngine(th, device="cpu")),
        "port_host": Executor(th),
    }


def answers(execs, q, shards=None):
    out = {k: [r.columns().tolist() if hasattr(r, "columns") else r
               for r in ex.execute("i", q, shards=shards).results]
           for k, ex in execs.items()}
    assert out["jfused"] == out["jhost"], q
    return out


SPANS = [
    ("2018-01-01T00:00", "2018-04-01T00:00"),  # bench.py's config 4: three month views
    ("2017-01-01T00:00", "2020-01-01T00:00"),  # three year views
    ("2017-03-15T00:00", "2018-02-03T00:00"),  # days, months, a year boundary
    ("2018-06-10T00:00", "2018-06-11T00:00"),  # one day view
    ("2016-01-01T00:00", "2017-01-01T00:00"),  # before any data
    ("2018-05-01T00:00", "2018-05-01T00:00"),  # empty
]


@pytest.mark.parametrize("shards", [None, [1, 2]], ids=["all", "subset"])
@pytest.mark.parametrize("row", [7, 8, 99])
@pytest.mark.parametrize("span", SPANS, ids=[s[0][:10] + "_" + s[1][:10] for s in SPANS])
def test_time_range_counts_match(execs, span, row, shards):
    q = f"Count(Range(t={row}, {span[0]}, {span[1]}))"
    port = execs["port"]
    before = port.host_fallbacks
    out = answers(execs, q, shards)
    assert out["port"] == out["jfused"] and out["port_host"] == out["jfused"], q
    assert port.host_fallbacks == before


@pytest.mark.parametrize("q", [
    "Count(Intersect(Row(g=1), Range(t=7, 2018-01-01T00:00, 2018-04-01T00:00)))",
    "Count(Difference(Range(t=7, 2017-01-01T00:00, 2019-01-01T00:00), "
    "Range(t=8, 2018-01-01T00:00, 2018-02-01T00:00)))",
    "Count(Range(s=7, 2017-01-01T00:00, 2019-01-01T00:00))",  # no time quantum: zero
    "Count(Range(h=1, 2018-02-03T05:00, 2018-02-03T09:00))",  # four hour views
])
def test_time_range_trees_match(execs, q):
    out = answers(execs, q)
    assert out["port"] == out["jfused"] and out["port_host"] == out["jfused"], q


def test_cover_past_the_leaf_table_takes_the_host_lane(execs):
    """At hour quantum a span of two days less two hours is a cover of 46
    hour views, past a tree's 32 leaves: the engine declines and the host
    lane answers."""
    start, end = "2018-02-03T01:00", "2018-02-04T23:00"
    views = timequantum.views_by_time_range(
        "standard", timequantum.parse_timestamp(start), timequantum.parse_timestamp(end), "YMDH")
    assert len(views) > kernels.MAX_LEAVES
    q = f"Count(Range(h=1, {start}, {end}))"
    port = execs["port"]
    before = port.host_fallbacks
    out = answers(execs, q)
    assert out["port"] == out["jfused"] and out["port_host"] == out["jfused"]
    assert port.host_fallbacks == before + 1


def test_row_results_match_host(execs):
    q = "Range(t=8, 2017-06-01T00:00, 2018-06-01T00:00)"
    out = answers(execs, q)
    assert out["port"] == out["jhost"] and out["port_host"] == out["jhost"]


def test_consecutive_time_range_counts_run_as_one_batch(execs):
    """A time-quantum Range lowers to row leaves, so K5 takes it: a query
    of consecutive such Counts is one batch launch and no decline."""
    eng = execs["port"].engine
    q = " ".join(f"Count(Range(t={r}, {a}, {b}))" for r in (7, 8) for a, b in SPANS[:3])
    d0, b0 = eng.batch_declines, eng.batch_dispatches
    out = answers(execs, q)
    assert out["port"] == out["jfused"]
    assert eng.batch_declines == d0 and eng.batch_dispatches == b0 + 1


def test_timestamped_write_stales_the_memo_and_syncs_in_place():
    """A Set with a timestamp writes the standard view and its time views;
    the memoized time Range over them misses, and the next Count sees the
    bit through the in-place sync."""
    data = seeded_data(3)
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    fill(jh, data, JFieldOptions)
    fill(th, data, TFieldOptions)
    jex = JExecutor(jh)
    port = Executor(th, engine=TorchEngine(th, device="cpu"))
    eng = port.engine
    q = "Count(Range(t=7, 2018-01-01T00:00, 2018-04-01T00:00))"
    n0 = port.execute("i", q).results[0]
    assert n0 == jex.execute("i", q).results[0]
    c = tpql.parse(q).calls[0].children[0]
    key, hit = eng.memo_probe("i", c, [0, 1, 2])
    assert hit == n0
    rebuilds = eng.stack_rebuilds
    col = next(x for x in range(SW, 2 * SW)
               if not th.fragment("i", "t", "standard_201802", 1).bit(7, x))
    for ex in (jex, port):
        ex.execute("i", f"Set({col}, t=7, 2018-02-14T10:00)")
    key2, hit2 = eng.memo_probe("i", c, [0, 1, 2])
    assert key2 != key and hit2 is None
    assert port.execute("i", q).results[0] == jex.execute("i", q).results[0] == n0 + 1
    assert eng.stack_rebuilds == rebuilds


def test_open_holder_answers_time_ranges_like_jax(tmp_path):
    """A JAX Holder's data directory with time views (written by timestamped
    imports and by a timestamped Set in the op-log) opens in the port and
    gives the same time-range answers, fused and on the host lane."""
    from pilosa_tpu_torch.convert import open_holder

    path = str(tmp_path / "data")
    jh = JHolder(path)
    jh.open()
    fill(jh, seeded_data(29), JFieldOptions)
    jex = JExecutor(jh)
    jex.execute("i", f"Set({SW + 11}, t=8, 2018-03-09T07:00)")
    queries = [f"Count(Range(t={r}, {a}, {b}))" for r in (7, 8) for a, b in SPANS[:4]]
    queries.append("Count(Range(h=1, 2018-02-03T05:00, 2018-02-03T09:00))")
    want = [jex.execute("i", q).results[0] for q in queries]
    jh.close()
    th = open_holder(path, device="cpu")
    assert "standard_201803" in th.index("i").field("t").views
    for port in (Executor(th, engine=TorchEngine(th, device="cpu")), Executor(th)):
        assert [port.execute("i", q).results[0] for q in queries] == want
    th.close()
