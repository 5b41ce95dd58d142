"""Repair-on-write in the port (pilosa_tpu_torch.core.delta, the delta
capture in core/fragment.py, parallel/repair.py and its consumers in the
engine and the executor) against the JAX package's, on the same Holder
data made from a numpy seed.

The reference runs a ``MeshEngine`` over one CPU mesh device, as its own
repair tests run it; the port runs ``TorchEngine(device="cpu")``.  Each
scenario runs once per package through the same code, and:

- the hub packets each write path publishes are equal across the two
  packages: version, shard, rows, word indexes, before-words, opaque;
- every served answer equals a recompute with the repair layer suspended
  and the memo cleared (asserted inside the scenario, in each package),
  and the port's answers and its ``repaired`` / ``fallbacks`` /
  ``touched_words`` tallies equal the reference's;
- the port's own cases: a repair over pool rows under a device budget, a
  repair followed by queries the repair layer declines on the same field
  (the resident stack must sync the writes the repair did not need), a
  cache-only TopN answered from the memo, and a repair-served Count's
  plan record, equal to the reference's (a memo hit, no touches).

Every result is an integer: exact agreement (tolerance 0)."""

import importlib
import threading

import numpy as np
import pytest
import torch

from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu_torch.parallel.engine import ROW_SHARD_BYTES, TorchEngine

SW = 1 << 20
N_SHARDS = 4
REF, PORT = "pilosa_tpu", "pilosa_tpu_torch"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1)


class Side:
    """One package's classes, so that a scenario runs unchanged on both."""

    def __init__(self, pkg, mesh1):
        self.port = pkg == PORT
        self.mesh1 = mesh1
        imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
        self.pql = imp("pql")
        self.FieldOptions = imp("core.field").FieldOptions
        self.HUB = imp("core.delta").HUB
        self.codec = imp("roaring.codec")
        self.wire = imp("net.wire")
        self._Holder = imp("core.holder").Holder
        self._Executor = imp("executor").Executor
        self._API = imp("api").API

    def holder(self):
        h = self._Holder(device="cpu") if self.port else self._Holder()
        h.open()
        return h

    def engine(self, h, **kw):
        if self.port:
            return TorchEngine(h, device="cpu", **kw)
        return MeshEngine(h, self.mesh1, **kw)

    def executor(self, h, eng):
        if self.port:
            return self._Executor(h, engine=eng)
        return self._Executor(h, mesh_engine=eng)

    def api(self, h, eng):
        if self.port:
            return self._API(holder=h, engine=eng)
        return self._API(holder=h, mesh_engine=eng)

    def dispatches(self, eng):
        """Count launches of the engine (the reference: its fused count
        dispatches)."""
        if self.port:
            return eng.dense_dispatches + eng.sparse_dispatches
        return eng.fused_dispatches

    def call(self, text):
        return self.pql.parse(text).calls[0]

    def js(self, result):
        return self.wire.result_to_json(result)


def tallies(eng):
    r = eng.repairs
    return dict(r.repaired), dict(r.fallbacks), r.touched_words


def both(mesh1, scenario):
    """Run ``scenario(side)`` on both packages; return (reference, port)."""
    return scenario(Side(REF, mesh1)), scenario(Side(PORT, mesh1))


def _build(side):
    """Index i over 4 shards, field f rows 10, 11, 12 of 50 bits a shard
    (the reference's ``tests/test_repair.py _build``)."""
    h = side.holder()
    f = h.create_index("i").create_field("f")
    rows, cols = [], []
    rng = np.random.default_rng(3)
    for s in range(N_SHARDS):
        for r in (10, 11, 12):
            for c in rng.choice(SW, size=50, replace=False):
                rows.append(r)
                cols.append(s * SW + int(c))
    f.import_bulk(rows, cols)
    return h


def _recount(eng, call, shards):
    with eng.repairs.suspended():
        eng.result_memo.clear()
        return eng.count("i", call, shards)


# -- the count scenarios (tests/test_repair.py) -------------------------------

SHARDS = list(range(N_SHARDS))
AND = "Intersect(Row(f=10), Row(f=11))"


def sc_count_serves_without_dispatch(side):
    h = _build(side)
    eng = side.engine(h)
    call = side.call(AND)
    out = [eng.count("i", call, SHARDS)]
    frag = h.fragment("i", "f", "standard", 2)
    frag.set_bit(10, 2 * SW + 7)
    frag.set_bit(11, 2 * SW + 7)
    d = side.dispatches(eng)
    got = eng.count("i", call, SHARDS)
    assert side.dispatches(eng) == d, "a repair must not dispatch"
    assert eng.repairs.repaired["count"] == 1
    out.append(got)
    t = tallies(eng)
    assert got == _recount(eng, call, SHARDS)
    hits = eng.result_memo.hits
    assert eng.count("i", call, SHARDS) == got
    assert eng.result_memo.hits == hits + 1
    return out, t


def sc_count_bulk_and_clear_bits(side):
    h = _build(side)
    eng = side.engine(h)
    call = side.call("Union(Row(f=10), Row(f=12))")
    out = [eng.count("i", call, SHARDS)]
    frag = h.fragment("i", "f", "standard", 1)
    frag.bulk_import([10] * 30 + [12] * 30, list(range(60)))
    frag.clear_bit(10, SW + 3)
    got = eng.count("i", call, SHARDS)
    assert eng.repairs.repaired["count"] >= 1
    out.append(got)
    t = tallies(eng)
    assert got == _recount(eng, call, SHARDS)
    return out, t


def sc_stale_result_unservable(side):
    h = _build(side)
    eng = side.engine(h)
    call = side.call(AND)
    out = [eng.count("i", call, SHARDS)]
    words = np.zeros(SW // 64, dtype=np.uint64)
    words[:4] = ~np.uint64(0)
    h.fragment("i", "f", "standard", 0).load_row_words(10, words)
    fb = eng.repairs.fallbacks["count"]
    got = eng.count("i", call, SHARDS)
    assert eng.repairs.fallbacks["count"] == fb + 1
    out.append(got)
    t = tallies(eng)
    assert got == _recount(eng, call, SHARDS)
    return out, t


def sc_write_race_lands_on_new_token(side):
    h = _build(side)
    eng = side.engine(h)
    call = side.call(AND)
    out = [eng.count("i", call, SHARDS)]
    frag = h.fragment("i", "f", "standard", 3)
    frag.set_bit(10, 3 * SW + 9)
    frag.set_bit(11, 3 * SW + 9)
    real = eng.repairs._truth_read
    raced = {"n": 0}

    def racing(entry, index, words, packets):
        if raced["n"] == 0:
            raced["n"] += 1
            frag.set_bit(10, 3 * SW + 10)
            frag.set_bit(11, 3 * SW + 10)
        return real(entry, index, words, packets)

    eng.repairs._truth_read = racing
    try:
        got = eng.count("i", call, SHARDS)
    finally:
        eng.repairs._truth_read = real
    assert raced["n"] == 1 and eng.repairs.repaired["count"] == 1
    out.append(got)
    t = tallies(eng)
    assert got == _recount(eng, call, SHARDS)
    return out, t


def sc_retries_exhausted(side):
    h = _build(side)
    eng = side.engine(h)
    call = side.call(AND)
    out = [eng.count("i", call, SHARDS)]
    frag = h.fragment("i", "f", "standard", 3)
    frag.set_bit(10, 3 * SW + 9)
    real = eng.repairs._truth_read
    calls = {"n": 0}

    def always_racing(entry, index, words, packets):
        calls["n"] += 1
        frag.set_bit(10, 3 * SW + 100 + calls["n"])
        return real(entry, index, words, packets)

    eng.repairs._truth_read = always_racing
    try:
        got = eng.count("i", call, SHARDS)
    finally:
        eng.repairs._truth_read = real
    assert calls["n"] == eng.repairs.MAX_ATTEMPTS
    assert eng.repairs.fallbacks["count"] == 1
    out.append(got)
    t = tallies(eng)
    assert got == _recount(eng, call, SHARDS)
    return out, t


def sc_concurrent_writes(side):
    """A writer thread streams a fixed, seeded run of bulk imports while
    Counts are served; every served value is a count some prefix of the
    stream gives, and the value after the stream equals a recompute.  The
    tallies depend on the interleaving, so only the final answer is
    compared across the packages."""
    h = _build(side)
    eng = side.engine(h)
    call = side.call(AND)
    eng.count("i", call, SHARDS)
    rng = np.random.default_rng(9)
    batches = [(int(rng.integers(0, N_SHARDS)), rng.integers(10, 12, 8), rng.integers(0, SW, 8))
               for _ in range(40)]
    go = threading.Event()

    def writer():
        go.wait()
        for s, r, c in batches:
            h.fragment("i", "f", "standard", s).bulk_import(r, c)

    t = threading.Thread(target=writer)
    t.start()
    go.set()
    try:
        for _ in range(20):
            eng.count("i", call, SHARDS)
    finally:
        t.join()
    got = eng.count("i", call, SHARDS)
    assert got == _recount(eng, call, SHARDS)
    return [got], None


def sc_hub_trim(side):
    h = _build(side)
    eng = side.engine(h)
    call = side.call(AND)
    out = [eng.count("i", call, SHARDS)]
    frag = h.fragment("i", "f", "standard", 0)
    old = side.HUB.PACKETS_MAX
    side.HUB.PACKETS_MAX = 8
    try:
        for i in range(40):
            frag.set_bit(10, i + 100)
        got = eng.count("i", call, SHARDS)
    finally:
        side.HUB.PACKETS_MAX = old
    assert eng.repairs.fallbacks["count"] == 1
    out.append(got)
    t = tallies(eng)
    assert got == _recount(eng, call, SHARDS)
    return out, t


def sc_unsubscribe_drops_log(side):
    h = _build(side)
    eng = side.engine(h)
    before = side.HUB.snapshot()["viewLogs"]
    out = [eng.count("i", side.call(AND), SHARDS)]
    out.append(side.HUB.snapshot()["viewLogs"] - before)
    eng.close()
    out.append(side.HUB.snapshot()["viewLogs"] - before)
    assert out[1:] == [1, 0]
    return out, tallies(eng)


def sc_sig_cache_second_chance(side):
    h = _build(side)
    eng = side.engine(h)
    hot = side.call(AND)
    out = [eng.count("i", hot, [0])]
    assert id(hot) in eng._memo_sig_cache
    churn = [side.call(f"Row(f={r})") for r in range(1100)]
    for i, c in enumerate(churn):
        eng._memo_key("i", c, [0])
        if i % 97 == 0:
            out.append(eng.count("i", hot, [0]))
    assert id(hot) in eng._memo_sig_cache, "hot entry evicted"
    assert len(eng._memo_sig_cache) <= eng._SIG_CACHE_MAX
    return out, tallies(eng)


# -- the aggregate scenarios, through the executor ----------------------------


def _oracle(eng, ex, query):
    with eng.repairs.suspended():
        eng.result_memo.clear()
        return ex.execute("i", query).results[0]


def _exec(side):
    h = side.holder()
    eng = side.engine(h)
    return h, eng, side.executor(h, eng)


def sc_topn(side):
    h, eng, ex = _exec(side)
    h.create_index("i").create_field("f")
    q = lambda s: ex.execute("i", s).results[0]  # noqa: E731
    q(f"Set(0, f=10) Set(1, f=10) Set({SW}, f=10) Set(0, f=11) Set(2, f=11) Set(3, f=12)")
    out = [side.js(q("TopN(f, n=3)"))]
    assert side.js(q("TopN(f, n=3)")) == out[0]
    q("Set(7, f=11) Set(8, f=11)")
    got = q("TopN(f, n=3)")
    assert eng.repairs.repaired["topn"] >= 1
    assert got == _oracle(eng, ex, "TopN(f, n=3)")
    out.append(side.js(got))
    q("Set(9, f=13)")  # a new row: a shape change, so a fallback
    got = q("TopN(f)")
    assert got == _oracle(eng, ex, "TopN(f)")
    out.append(side.js(got))
    return out, tallies(eng)


def sc_groupby(side):
    h, eng, ex = _exec(side)
    idx = h.create_index("i")
    idx.create_field("a")
    idx.create_field("b")
    q = lambda s: ex.execute("i", s).results[0]  # noqa: E731
    q("Set(0, a=1) Set(1, a=1) Set(2, a=2) Set(0, b=10) Set(1, b=11) Set(2, b=10)")
    G = "GroupBy(Rows(field=a), Rows(field=b))"
    out = [side.js(q(G))]
    assert side.js(q(G)) == out[0]
    q("Set(5, a=2) Set(5, b=11)")
    got = q(G)
    assert eng.repairs.repaired["groupby"] >= 1
    assert side.js(got) == side.js(_oracle(eng, ex, G))
    out.append(side.js(got))
    GF = "GroupBy(Rows(field=a), filter=Row(b=10))"
    out.append(side.js(q(GF)))
    q("Set(6, a=1) Set(6, b=10)")
    got = q(GF)
    assert side.js(got) == side.js(_oracle(eng, ex, GF))
    out.append(side.js(got))
    return out, tallies(eng)


def sc_sum(side):
    h, eng, ex = _exec(side)
    idx = h.create_index("i")
    idx.create_field("f")
    idx.create_field("v", side.FieldOptions(type="int", min=0, max=1000))
    q = lambda s: side.js(ex.execute("i", s).results[0])  # noqa: E731
    o = lambda s: side.js(_oracle(eng, ex, s))  # noqa: E731
    q(f"Set(0, f=10) Set(1, f=10) Set(0, v=5) Set(1, v=9) Set(2, v=100) Set({SW + 1}, v=200)")
    out = [q("Sum(field=v)")]
    assert q("Sum(field=v)") == out[0]
    q(f"Set(3, v=77) Set({SW + 2}, v=40)")
    got = q("Sum(field=v)")
    assert eng.repairs.repaired["sum"] >= 1 and got == o("Sum(field=v)")
    out.append(got)
    rep = eng.repairs.repaired["sum"]
    q(f"Set({2 * SW + 1}, v=300)")  # a new shard: a new signature
    got = q("Sum(field=v)")
    assert got == o("Sum(field=v)") and eng.repairs.repaired["sum"] == rep
    out.append(got)
    q("Set(2, v=1)")
    got = q("Sum(field=v)")
    assert got == o("Sum(field=v)")
    out.append(got)
    SF = "Sum(Row(f=10), field=v)"
    out.append(q(SF))
    q("Set(0, v=6)")
    got = q(SF)
    assert got == o(SF)
    out.append(got)
    return out, tallies(eng)


def sc_min_max(side):
    h, eng, ex = _exec(side)
    idx = h.create_index("i")
    idx.create_field("f")
    idx.create_field("v", side.FieldOptions(type="int", min=0, max=1000))
    q = lambda s: side.js(ex.execute("i", s).results[0])  # noqa: E731
    o = lambda s: side.js(_oracle(eng, ex, s))  # noqa: E731
    q(f"Set(0, v=5) Set(1, v=9) Set(2, v=100) Set({SW + 1}, v=200) Set({SW + 2}, v=100)")
    out = [q("Min(field=v)"), q("Max(field=v)")]
    assert q("Min(field=v)") == out[0] and q("Max(field=v)") == out[1]
    q(f"Set({SW + 1}, v=7)")
    got = q("Max(field=v)")
    assert eng.repairs.repaired["minmax"] >= 1 and got == o("Max(field=v)")
    out += [got, q("Min(field=v)")]
    assert out[-1] == o("Min(field=v)")
    q("Set(5, v=999)")
    out.append(q("Max(field=v)"))
    assert out[-1] == o("Max(field=v)")
    q(f"Set({SW + 3}, v=999)")  # a tie across shards
    out.append(q("Max(field=v)"))
    assert out[-1] == o("Max(field=v)")
    q("Set(1, f=10) Set(2, f=10)")
    MF = "Min(Row(f=10), field=v)"
    out.append(q(MF))
    assert q(MF) == out[-1]
    rep = eng.repairs.repaired["minmax"]
    q("Set(0, f=10)")
    out.append(q(MF))
    assert out[-1] == o(MF) and eng.repairs.repaired["minmax"] > rep
    return out, tallies(eng)


def sc_min_max_band_drain(side):
    h, eng, ex = _exec(side)
    h.create_index("i").create_field("v", side.FieldOptions(type="int", min=0, max=1000))
    q = lambda s: side.js(ex.execute("i", s).results[0])  # noqa: E731
    n_vals = eng.repairs.MINMAX_TABLE_K + 4
    q(" ".join(f"Set({c}, v={100 + c})" for c in range(n_vals)))
    out = [q("Max(field=v)")]
    assert out[0] == {"value": 100 + n_vals - 1, "count": 1}
    q(" ".join(f"Set({c}, v=1)" for c in range(n_vals)))
    fb = eng.repairs.fallbacks["minmax"]
    got = q("Max(field=v)")
    assert eng.repairs.fallbacks["minmax"] == fb + 1
    assert got == side.js(_oracle(eng, ex, "Max(field=v)"))
    out.append(got)
    return out, tallies(eng)


def sc_cq_stream(side):
    h = side.holder()
    idx = h.create_index("i")
    idx.create_field("f")
    eng = side.engine(h)
    api = side.api(h, eng)
    ex = api.executor
    ex.execute("i", "Set(1, f=10) Set(2, f=10) Set(1, f=11)")
    doc = api.cq.create("i", "Count(Intersect(Row(f=10), Row(f=11)))")
    out = [doc["seq"], doc["result"]]
    qid = doc["id"]
    try:
        assert api.cq.poll(qid, since=1, wait_ms=10)["deltas"] == []
        ex.execute("i", "Set(2, f=11)")
        got = api.cq.poll(qid, since=1, wait_ms=5000)
        assert got["deltas"] and got["deltas"][-1]["result"] == [2], got
        out.append([(d["seq"], d["result"]) for d in got["deltas"]])
        ex.execute("i", "Set(9, f=12)")
        assert api.cq.poll(qid, since=got["seq"], wait_ms=200)["deltas"] == []
        api.cq.delete(qid)
        with pytest.raises(KeyError):
            api.cq.poll(qid, since=0, wait_ms=0)
        # The sweeper's re-execution after the first write was a repair.
        assert eng.repairs.repaired["count"] >= 1
    finally:
        api.cq.close()
    return out, tallies(eng)


SCENARIOS = {
    "count_serves_without_dispatch": sc_count_serves_without_dispatch,
    "count_bulk_and_clear_bits": sc_count_bulk_and_clear_bits,
    "stale_result_unservable": sc_stale_result_unservable,
    "write_race_lands_on_new_token": sc_write_race_lands_on_new_token,
    "retries_exhausted": sc_retries_exhausted,
    "concurrent_writes": sc_concurrent_writes,
    "topn": sc_topn,
    "groupby": sc_groupby,
    "sum": sc_sum,
    "min_max": sc_min_max,
    "min_max_band_drain": sc_min_max_band_drain,
    "hub_trim": sc_hub_trim,
    "unsubscribe_drops_log": sc_unsubscribe_drops_log,
    "sig_cache_second_chance": sc_sig_cache_second_chance,
    "cq_stream": sc_cq_stream,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_repair_as_the_reference(mesh1, name):
    """The reference's repair scenario ``name``: each package's served
    answers equal its recompute (asserted inside), and the port's answers
    and tallies equal the reference's."""
    ref, port = both(mesh1, SCENARIOS[name])
    assert port[0] == ref[0]
    assert port[1] == ref[1]


# -- the hub packets of every write path --------------------------------------


def _packet_fixture(side):
    """Index p over 2 shards: f (standard) rows 1-3, m (mutex) rows 1-2, v
    (int 0..1000); the holder and the columns written."""
    h = side.holder()
    idx = h.create_index("p")
    rng = np.random.default_rng(5)
    f = idx.create_field("f")
    cols = rng.choice(2 * SW, 600, replace=False)
    rows = rng.integers(1, 4, cols.size)
    f.import_bulk(rows.tolist(), cols.tolist())
    m = idx.create_field("m", side.FieldOptions(type="mutex"))
    mc = rng.choice(2 * SW, 200, replace=False)
    mrows = rng.integers(1, 3, mc.size)
    m.import_bulk(mrows.tolist(), mc.tolist())
    v = idx.create_field("v", side.FieldOptions(type="int", min=0, max=1000))
    vc = rng.choice(2 * SW, 100, replace=False)
    v.import_values(vc.tolist(), rng.integers(0, 1001, vc.size).tolist())
    f1 = int(cols[(rows == 1) & (cols < SW)][0])
    m1 = int(mc[(mrows == 1) & (mc < SW)][0])
    return h, {"f": cols, "f1": f1, "m": mc, "m1": m1, "v": vc}


def _dense_words(seed, n_bits):
    w = np.zeros(SW // 64, dtype=np.uint64)
    pos = np.random.default_rng(seed).choice(SW, n_bits, replace=False)
    np.bitwise_or.at(w, pos >> 6, np.uint64(1) << (pos & 63).astype(np.uint64))
    return w


def _roaring(side, rows, n_bits, seed):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([np.uint64(r * SW) + rng.choice(SW, n_bits, replace=False).astype(np.uint64)
                          for r in rows])
    return side.codec.serialize(np.unique(pos))


WRITES = {
    # name: (field, view, write(side, holder, fixture columns))
    "set_bit": ("f", "standard", lambda s, h, d: h.fragment("p", "f", "standard", 0)
                .set_bit(1, 12345)),
    "clear_bit": ("f", "standard", lambda s, h, d: h.fragment("p", "f", "standard", 0)
                  .clear_bit(1, d['f1'])),
    "mutex_set_bit": ("m", "standard", lambda s, h, d: h.fragment("p", "m", "standard", 0)
                      .set_bit(2, d['m1'])),
    "set_value": ("v", "bsig_v", lambda s, h, d: h.fragment("p", "v", "bsig_v", 0)
                  .set_value(int(d['v'][d['v'] < SW][0]), 10, 777)),
    "clear_value": ("v", "bsig_v", lambda s, h, d: h.fragment("p", "v", "bsig_v", 0)
                    .clear_value(int(d['v'][d['v'] < SW][0]), 10, 0)),
    "bulk_import": ("f", "standard", lambda s, h, d: h.fragment("p", "f", "standard", 1)
                    .bulk_import([1, 2, 3, 3], [SW + 5, SW + 70, SW + 71, int(d['f'][d['f'] >= SW][0])])),
    "bulk_import_clear": ("f", "standard", lambda s, h, d: h.fragment("p", "f", "standard", 0)
                          .bulk_import([1, 2, 3], d['f'][d['f'] < SW][:3].tolist(), clear=True)),
    "bulk_import_mutex": ("m", "standard", lambda s, h, d: h.fragment("p", "m", "standard", 0)
                          .bulk_import([1, 2, 1], d['m'][d['m'] < SW][:3].tolist())),
    "import_values": ("v", "bsig_v", lambda s, h, d: h.fragment("p", "v", "bsig_v", 1)
                      .import_values([SW + 3, int(d['v'][d['v'] >= SW][0])], [12, 900], 10)),
    "import_roaring": ("f", "standard", lambda s, h, d: h.fragment("p", "f", "standard", 0)
                       .import_roaring(_roaring(s, [1, 5], 40, 8))),
    "import_roaring_dense": ("f", "standard", lambda s, h, d: h.fragment(
        "p", "f", "standard", 0).import_roaring(_roaring(s, [2], 70000, 9))),
    "import_roaring_clear": ("f", "standard", lambda s, h, d: h.fragment(
        "p", "f", "standard", 0).import_roaring(_roaring(s, [1], 40, 8), clear=True)),
    "clear_row": ("f", "standard", lambda s, h, d: h.fragment("p", "f", "standard", 1)
                  .clear_row(2)),
    "set_row": ("f", "standard", lambda s, h, d: h.fragment("p", "f", "standard", 0)
                .set_row(h.fragment("p", "f", "standard", 0).row(3), 1)),
    "load_row_words": ("f", "standard", lambda s, h, d: h.fragment("p", "f", "standard", 0)
                       .load_row_words(4, _dense_words(4, 5000))),
}


def _packets(side, name):
    field, view, write = WRITES[name]
    h, d = _packet_fixture(side)
    if name == "import_roaring_clear":
        h.fragment("p", "f", "standard", 0).import_roaring(_roaring(side, [1], 40, 8))
    vobj = h.index("p").field(field).views[view]
    vkey = ("p", field, view, vobj.gen)
    base = vobj.version
    side.HUB.subscribe(vkey, base)
    try:
        write(side, h, d)
        pk = side.HUB.packets_for(vkey, base, vobj.version)
    finally:
        side.HUB.unsubscribe(vkey)
    assert pk is not None and len(pk) >= 1
    return [(p.version, p.shard, p.opaque,
             None if p.opaque else (p.rows.tolist(), p.widxs.tolist(), p.before.tolist()))
            for p in pk]


@pytest.mark.parametrize("name", list(WRITES))
def test_write_path_packets_as_the_reference(mesh1, name):
    """The packets one write publishes to the delta hub, equal across the
    packages; ``load_row_words`` publishes OPAQUE, every other path its
    touched words with their before-values."""
    ref = _packets(Side(REF, mesh1), name)
    port = _packets(Side(PORT, mesh1), name)
    assert port == ref
    assert all(p[2] for p in port) == (name == "load_row_words")


def test_unsubscribed_write_publishes_nothing(mesh1):
    """With no subscription a write captures nothing: the hub keeps no log
    and the fragment stages no delta."""
    side = Side(PORT, mesh1)
    h, _ = _packet_fixture(side)
    frag = h.fragment("p", "f", "standard", 0)
    assert not frag._delta_wanted()
    logs = side.HUB.snapshot()["viewLogs"]
    frag.set_bit(1, 777)
    frag.bulk_import([2, 3], [5, 6])
    assert frag._delta_pending is None
    assert side.HUB.snapshot()["viewLogs"] == logs


# -- the port's own cases -----------------------------------------------------


def test_repair_then_declined_queries_see_every_write(mesh1):
    """A repaired serve reads the fragments and leaves the resident stack
    behind the writes; the next queries that the repair layer declines (a
    new tree, a TopN with a src, a GroupBy) dispatch, sync the stack in
    place and see every write.  Answers as the reference's."""
    def run(side):
        h, eng, ex = _exec(side)
        idx = h.create_index("i")
        idx.create_field("f")
        idx.create_field("g")
        q = lambda s: side.js(ex.execute("i", s).results[0])  # noqa: E731
        rng = np.random.default_rng(11)
        cols = rng.choice(N_SHARDS * SW, 3000, replace=False)
        idx.field("f").import_bulk(rng.integers(0, 6, cols.size).tolist(), cols.tolist())
        idx.field("g").import_bulk(rng.integers(0, 3, cols.size).tolist(), cols.tolist())
        C = "Count(Intersect(Row(f=1), Row(g=1)))"
        out = [q(C)]
        frag = h.fragment("i", "f", "standard", 2)
        for c in cols[(cols >> 20) == 2][:5].tolist():
            frag.set_bit(1, c)
        d = side.dispatches(eng)
        out.append(q(C))
        assert side.dispatches(eng) == d and eng.repairs.repaired["count"] == 1
        for query in ("Count(Union(Row(f=1), Row(f=2)))", "TopN(f, Row(g=1), n=4)",
                      "GroupBy(Rows(field=f), Rows(field=g))", "Row(f=1)"):
            out.append(q(query))
            assert out[-1] == side.js(_oracle(eng, ex, query)), query
        if side.port:
            assert eng.stack_updates >= 1
        return out

    ref, port = both(mesh1, run)
    assert port == ref


def _build_blocks(side):
    """``_build``'s rows with their bits in 2 of the 512 blocks of each
    shard, so that the rows a Count reads fit a pool below one stack."""
    h = side.holder()
    f = h.create_index("i").create_field("f")
    rows, cols = [], []
    rng = np.random.default_rng(3)
    for s in range(N_SHARDS):
        for r in (10, 11, 12):
            for c in rng.choice(4096, size=50, replace=False):
                rows.append(r)
                cols.append(s * SW + (int(c) + 2048 * s) % SW)
    f.import_bulk(rows, cols)
    return h


def test_repair_over_pool_rows(mesh1):
    """Under a device budget below one full stack a Count runs on pool rows
    (K1P on the card); the entry it registers repairs from the fragments
    after a write, with no launch and the pool untouched, and the answer
    equals the recompute and the reference's."""
    side = Side(PORT, mesh1)
    h = _build_blocks(side)
    eng = side.engine(h, max_resident_bytes=2 * N_SHARDS * ROW_SHARD_BYTES)
    ex = side.executor(h, eng)
    C = "Count(Intersect(Row(f=10), Row(f=11)))"
    first = ex.execute("i", C).results[0]  # a host fallback that asks for a promotion
    assert eng.host_fallbacks == 1
    assert eng.residency.flush(30.0)
    st = eng._stacks[("i", "f", "standard")]
    assert st.pool
    eng.result_memo.clear()
    eng.repairs.clear()
    call = side.call(AND)
    d = side.dispatches(eng)
    assert eng.count("i", call, SHARDS) == first
    assert side.dispatches(eng) == d + 1 and eng.repairs.snapshot()["entries"] == 1
    before = (st.matrix.clone(), st.slot_table.clone(), st.pool_next)
    frag = h.fragment("i", "f", "standard", 1)
    frag.set_bit(10, SW + 77)
    frag.set_bit(11, SW + 77)
    got = eng.count("i", call, SHARDS)
    assert side.dispatches(eng) == d + 1 and eng.repairs.repaired["count"] == 1
    assert eng._stacks[("i", "f", "standard")] is st
    assert torch.equal(st.matrix, before[0]) and torch.equal(st.slot_table, before[1])
    assert st.pool_next == before[2]
    ref = Side(REF, mesh1)
    jh = _build_blocks(ref)
    jf = jh.fragment("i", "f", "standard", 1)
    jf.set_bit(10, SW + 77)
    jf.set_bit(11, SW + 77)
    want = ref.engine(jh).count("i", ref.call(AND), SHARDS)
    assert got == want == first + 1
    assert got == _recount(eng, call, SHARDS)
    eng.close()


def test_cache_only_topn_memo_hits(mesh1):
    """A repeat of a cache-only TopN is answered from the memo with its
    plan noting ``path="memo"``; after a write the repair layer serves it;
    the answers are the reference's."""
    def run(side):
        h = side.holder()
        eng = side.engine(h)
        api = side.api(h, eng)
        api.create_index("i").create_field("f")
        api.executor.execute("i", "Set(0, f=1) Set(1, f=1) Set(2, f=2) Set(3, f=3) Set(4, f=3)")
        req = importlib.import_module(("pilosa_tpu_torch" if side.port else "pilosa_tpu")
                                      + ".api").QueryRequest
        first = api.query(req("i", "TopN(f, n=2)"))
        hits = eng.result_memo.hits
        again = api.query(req("i", "TopN(f, n=2)", profile=True))
        assert eng.result_memo.hits == hits + 1
        assert again.plan["ops"][0] == {"op": "TopN", "path": "memo", "memo": "hit"}
        api.executor.execute("i", "Set(5, f=2) Set(6, f=2)")
        third = api.query(req("i", "TopN(f, n=2)"))
        assert eng.repairs.repaired["topn"] == 1
        ops = [{k: v for k, v in o.items() if k != "seconds"} for o in again.plan["ops"]]
        return [side.js(r.results[0]) for r in (first, again, third)], ops, tallies(eng)

    ref, port = both(mesh1, run)
    assert port == ref


def test_repair_served_plan_as_the_reference(mesh1):
    """A Count that the repair layer serves after a write is recorded, in
    both packages, as a memo hit with no dispatch and no touches: the plan
    records agree field for field (timings aside)."""
    from test_torch_plans import norm_plan

    def run(side):
        h = side.holder()
        eng = side.engine(h)
        api = side.api(h, eng)
        api.create_index("i").create_field("f")
        req = importlib.import_module(("pilosa_tpu_torch" if side.port else "pilosa_tpu")
                                      + ".api").QueryRequest
        api.query(req("i", f"Set(1, f=1) Set(2, f=1) Set(2, f=2) Set({SW + 3}, f=2)"))
        q = "Count(Intersect(Row(f=1), Row(f=2)))"
        plans = [norm_plan(api.query(req("i", q, profile=True)).plan, not side.port)]
        api.query(req("i", "Set(3, f=1) Set(3, f=2)"))  # shard 0 holds every fragment
        got = api.query(req("i", q, profile=True))
        plans.append(norm_plan(got.plan, not side.port))
        assert got.results == [2] and eng.repairs.repaired["count"] == 1
        return plans, tallies(eng)

    ref, port = both(mesh1, run)
    assert port == ref
    assert port[0][1]["ops"] == [{"op": "Count", "path": "memo", "memo": "hit"}]
