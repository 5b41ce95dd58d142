"""The port's pipelined Count serving (pilosa_tpu_torch.parallel.batcher and
Executor.execute_async) — the counterparts of tests/test_pipeline.py that
need no HTTP server: batches genuinely in flight and a bounded depth
(against a stub engine), the group signature, and deferred queries against
the JAX package's Executor on the same seeded data (exact: counts are
integers).  The HTTP deferral waits for the port's server (ROADMAP.md
Queue 1 item 14)."""

import threading
import time

import numpy as np
import pytest

from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.parallel.batcher import CountBatcher as JCountBatcher
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor.executor import Executor as TExecutor
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.parallel.batcher import CountBatcher
from pilosa_tpu_torch.parallel.engine import TorchEngine

SW = bitops.SHARD_WIDTH


def fill(holder):
    """Index "i", field f: rows 10 and 11 over 8 shards (test_pipeline.py's
    data), with existence."""
    idx = holder.create_index("i")
    f = idx.create_field("f")
    rows, cols = [], []
    rng = np.random.default_rng(7)
    for s in range(8):
        picks = s * SW + rng.choice(SW, size=300, replace=False)
        rows += [10] * 200 + [11] * 200
        cols += picks[:200].tolist() + picks[100:].tolist()
    f.import_bulk(rows, cols)
    idx.existence_field().import_bulk([0] * len(cols), cols)
    return holder


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture
def pair(mesh):
    """(JAX Executor with a MeshEngine, port Executor with a TorchEngine)
    over twin holders."""
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    fill(jh)
    fill(th)
    teng = TorchEngine(th, device="cpu")
    yield JExecutor(jh, mesh_engine=MeshEngine(jh, mesh)), TExecutor(th, engine=teng)
    teng.close()


def _call(q):
    return tpql.parse(q).calls[0]


# -- stage-decoupled pipeline: batches in flight ---------------------------


class _SlowDev:
    """A stand-in for a batch's answers on the card: reading it back
    blocks until the stub engine's release gate opens."""

    def __init__(self, eng, values):
        self._eng = eng
        self._values = values

    def __array__(self, dtype=None, copy=None):
        self._eng.release.wait(30)
        with self._eng.lock:
            self._eng.unread -= 1
        return np.asarray(self._values, dtype=dtype or np.int64)


class _StubEngine:
    """count_many_async returns at once (the dispatch stage never waits on
    the device); readbacks block until ``release`` opens, so a test sees
    how many batches the pipeline keeps in flight."""

    def __init__(self):
        self.lock = threading.Lock()
        self.release = threading.Event()
        self.unread = 0
        self.max_unread = 0
        self.batches = []  # (index, len(calls)) of each count_many_async

    def count_many_async(self, index, calls, shards_list):
        with self.lock:
            self.unread += 1
            self.max_unread = max(self.max_unread, self.unread)
            self.batches.append((index, len(calls)))
        # The answer is the row id queried, so results are checkable.
        return _SlowDev(self, [int(str(c).split("=")[1].rstrip(")")) for c in calls])

    def count(self, index, call, shards):
        return int(str(call).split("=")[1].rstrip(")"))


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


def test_two_batches_genuinely_in_flight():
    """The readback of batch k overlaps the dispatch of batch k+1 and the
    accumulation of batch k+2."""
    eng = _StubEngine()
    b = CountBatcher(eng, max_inflight=4)
    try:
        # Distinct indexes: one batch each.
        wave1 = [b.submit_async(f"i{k}", _call(f"Row(f{k}=5)"), [0]) for k in range(2)]
        assert _wait_for(lambda: eng.unread >= 2), "second batch not dispatched while first unread"
        wave2 = b.submit_async("i9", _call("Row(f9=7)"), [0])
        assert _wait_for(lambda: eng.unread >= 3)
        eng.release.set()
        for it in wave1 + [wave2]:
            assert it.event.wait(30) and it.error is None
        assert wave1[0].result == 5 and wave2.result == 7
        assert eng.max_unread >= 3
        snap = b.pipeline_snapshot()
        assert snap["gauges"]["inflight_max"] >= 3 and snap["depth"] == 4
        assert {"queue_wait", "lower_dispatch", "device_readback"} <= set(snap["stages"])
    finally:
        eng.release.set()
        b.stop()


def test_inflight_depth_is_bounded():
    """With depth 2 and 4 distinct groups (indexes) queued, at most 2 are
    ever unread at once."""
    eng = _StubEngine()
    b = CountBatcher(eng, max_inflight=2)
    try:
        items = [b.submit_async(f"i{k}", _call(f"Row(g{k}={k})"), [0]) for k in range(4)]
        assert _wait_for(lambda: eng.unread >= 2)
        time.sleep(0.25)  # time for an over-eager dispatcher to go past it
        assert eng.max_unread <= 2, "pipeline exceeded its configured depth"
        eng.release.set()
        for k, it in enumerate(items):
            assert it.event.wait(30) and it.error is None and it.result == k
        assert b.pipeline_snapshot()["gauges"]["inflight_max"] <= 2
    finally:
        eng.release.set()
        b.stop()


def test_drain_groups_by_index_alone():
    """K5 takes any mix of trees, so one drain makes one batch per index,
    whatever the trees' structures (the reference splits by _signature)."""
    eng = _StubEngine()
    b = CountBatcher(eng, max_inflight=4)
    try:
        # A batch in flight (unread), so the next arrivals accumulate.
        first = b.submit_async("j", _call("Row(a=1)"), [0])
        assert _wait_for(lambda: eng.unread >= 1)
        qs = ["Row(a=2)", "Row(b1=3)", "Row(b2=4)", "Intersect(Row(c=5))"]
        items = [b.submit_async("i", _call(q), [0]) for q in qs]
        items.append(b.submit_async("k", _call("Row(a=6)"), [0]))
        assert _wait_for(lambda: len(eng.batches) >= 3)
        time.sleep(0.25)  # time for a split drain to dispatch a fourth batch
        eng.release.set()
        assert first.event.wait(30) and first.result == 1
        for it, want in zip(items, (2, 3, 4, 5, 6)):
            assert it.event.wait(30) and it.error is None and it.result == want
        assert sorted(eng.batches) == [("i", 4), ("j", 1), ("k", 1)]
        assert len({CountBatcher._signature("i", _call(q)) for q in qs}) == 4
    finally:
        eng.release.set()
        b.stop()


def test_pipeline_depth_env_override(monkeypatch):
    monkeypatch.setenv("PILOSA_PIPELINE_DEPTH", "7")
    assert CountBatcher(_StubEngine()).max_inflight == 7
    assert CountBatcher(_StubEngine(), max_inflight=3).max_inflight == 3


def test_stop_joins_the_workers():
    eng = _StubEngine()
    eng.release.set()
    b = CountBatcher(eng, max_inflight=2)
    assert b.submit_async("i", _call("Row(h=3)"), [0]).event.wait(30)
    threads = list(b._threads)
    assert len(threads) == 4 and all(t.is_alive() for t in threads)
    b.stop()
    assert not any(t.is_alive() for t in threads)


# -- signatures ------------------------------------------------------------


@pytest.mark.parametrize("a, b, same", [
    ("Row(f1=3)", "Row(f2=3)", False),  # digits inside identifiers are structure
    ("Row(f1=3)", "Row(f1=4)", True),  # literals in argument position are data
    ("Row(f=3)", "Row(f=999)", True),
    ("Intersect(Row(f=10), Row(f=11))", "Intersect(Row(f=3), Row(f=4))", True),
    ("Intersect(Row(f=10), Row(f=11))", "Union(Row(f=10), Row(f=11))", False),
    ("Range(v > 300)", "Range(v > 7)", True),
    ("Range(t=7, 2018-01-01T00:00, 2018-04-01T00:00)",
     "Range(t=7, 2018-01-01T00:00, 2018-02-01T00:00)", False),  # timestamps: structure
])
def test_signature_masks_only_argument_literals(a, b, same):
    from pilosa_tpu import pql as jpql

    sig, jsig = CountBatcher._signature, JCountBatcher._signature
    assert (sig("i", _call(a)) == sig("i", _call(b))) is same
    assert sig("i", _call(a)) == jsig("i", jpql.parse(a).calls[0])


def test_digit_field_batches_fuse_correctly(pair):
    """Digit-bearing field names answer correctly through the batcher,
    batched together or not."""
    jex, tex = pair
    for ex in (jex, tex):
        idx = ex.holder.index("i")
        idx.create_field("f1").import_bulk([3] * 50, list(range(50)))
        idx.create_field("f2").import_bulk([3] * 20, list(range(0, 200, 10)))
    b = tex.engine.batcher()
    shards = list(range(8))
    qs = ["Intersect(Row(f1=3), Row(f1=3))", "Union(Row(f2=3), Row(f2=4))"]
    items = [b.submit_async("i", _call(q), shards) for q in qs]
    for it in items:
        assert it.event.wait(60) and it.error is None
    want = [jex.execute("i", f"Count({q})").results[0] for q in qs]
    assert [it.result for it in items] == want == [50, 20]


# -- Executor.execute_async --------------------------------------------------

MULTI = ("Count(Row(f=10))"
         "Count(Intersect(Row(f=10), Row(f=11)))"
         "Count(Union(Row(f=10), Row(f=11)))"
         "Count(Not(Row(f=11)))")


def test_execute_async_matches_sync(pair):
    jex, tex = pair
    want = jex.execute("i", MULTI).results
    assert tex.execute("i", MULTI).results == want
    fut = tex.execute_async("i", MULTI)
    assert fut is not None
    assert fut.result(60).results == want
    assert tex.async_fallbacks == 0
    # An all-O(1) query resolves with no batcher item at all.
    fut = tex.execute_async("i", "Count(Row(f=11))")
    assert fut.done() and fut.result(0).results == jex.execute("i", "Count(Row(f=11))").results


def test_execute_async_declines_non_count(pair):
    jex, tex = pair
    assert jex.execute_async("i", "TopN(f, n=2)") is None
    assert tex.execute_async("i", "TopN(f, n=2)") is None
    assert tex.execute_async("i", "Set(1, f=10)") is None
    assert tex.execute_async("i", "Count(Row(f=10))Set(1, f=10)") is None
    assert tex.execute_async("i", "Count(Shift(Row(f=10), n=1))") is None  # not lowerable
    assert tex.execute_async("nosuchindex", "Count(Row(f=10))") is None
    assert tex.execute_async("i", "Count(Row(f=10)") is None  # a parse error
    assert TExecutor(tex.holder).execute_async("i", "Count(Row(f=10))") is None  # no engine


def test_execute_async_error_converges_to_sync(pair):
    """An item that fails at lowering falls back to the sync path, so both
    paths give the same outcome (the host lane's field-not-found), and
    the fallback is counted."""
    jex, tex = pair
    q = "Count(Intersect(Row(f=10), Row(missingfield=1)))"
    outcomes = []
    for call in (lambda: tex.execute("i", q), lambda: tex.execute_async("i", q).result(60),
                 lambda: jex.execute("i", q)):
        try:
            outcomes.append(("ok", call().results))
        except Exception as e:  # noqa: BLE001
            outcomes.append(("error", type(e).__name__))
    assert outcomes[0] == outcomes[1] == outcomes[2] == ("error", "FieldNotFoundError")
    assert tex.async_fallbacks == 1


def test_execute_async_callback_fires(pair):
    jex, tex = pair
    fired = threading.Event()
    out = []
    fut = tex.execute_async("i", "Count(Intersect(Row(f=10), Row(f=11)))")
    fut.add_done_callback(lambda f: (out.append(f.result(0).results), fired.set()))
    assert fired.wait(60)
    assert out[0] == jex.execute("i", "Count(Intersect(Row(f=10), Row(f=11)))").results
    # A callback added after resolution runs at once.
    late = []
    fut.add_done_callback(lambda f: late.append(f.done()))
    assert late == [True]


def test_concurrent_execute_async_fuses(pair):
    jex, tex = pair
    tex.engine.result_memo.maxsize = 0
    qs = [f"Count(Intersect(Row(f=10), Row(f={r})))" for r in (10, 11, 12)] + [
        "Count(Xor(Row(f=10), Row(f=11)))", "Count(Difference(Row(f=11), Row(f=10)))"]
    want = {q: jex.execute("i", q).results for q in qs}
    futs = []
    for _ in range(6):
        futs += [(q, tex.execute_async("i", q)) for q in qs]
    for q, fut in futs:
        assert fut.result(60).results == want[q]
    b = tex.engine._batcher
    assert b.batched_queries == len(futs) and b.batches < len(futs)
    assert tex.async_fallbacks == 0


# -- mixed read/write streams ------------------------------------------------


def test_mixed_read_write_stream_stays_correct(pair):
    """A writer adds bits while a reader streams deferred Counts: every
    count is monotone nondecreasing (adds only), every Count submitted
    after a write returned sees it, and the quiesced answer equals the
    JAX executor's."""
    jex, tex = pair
    f = tex.holder.index("i").field("f")
    q = "Count(Union(Row(f=10), Row(f=11)))"
    base = tex.execute_async("i", q).result(60).results[0]
    stop = threading.Event()
    errors, seen = [], []
    written = [0]

    def writer():
        try:
            for n in range(1, 41):
                cols = [s * SW + 5000 + (n * 13 + s) % 3000 for s in range(8)]
                f.import_bulk([10] * len(cols), cols)
                written[0] = n
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                n0 = written[0]
                fut = tex.execute_async("i", q)
                assert fut is not None
                seen.append((n0, fut.result(60).results[0]))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    w = threading.Thread(target=writer)
    r = threading.Thread(target=reader)
    w.start()
    r.start()
    w.join(60)
    time.sleep(0.1)
    stop.set()
    r.join(60)
    assert not w.is_alive() and not r.is_alive(), "worker deadlocked"
    assert not errors, errors
    assert seen and seen[0][1] >= base
    for (_, a), (_, b) in zip(seen, seen[1:]):
        assert b >= a, (a, b)
    # The reference after each write: a Count submitted after write n
    # returned must see at least write n's count.
    jf = jex.holder.index("i").field("f")
    after = []
    for n in range(1, 41):
        jf.import_bulk([10] * 8, [s * SW + 5000 + (n * 13 + s) % 3000 for s in range(8)])
        after.append(jex.execute("i", q).results[0])
    assert tex.execute_async("i", q).result(60).results == [after[-1]]
    assert tex.execute("i", q).results == [after[-1]]
    for n0, got in seen:
        assert (after[n0 - 1] if n0 else base) <= got <= after[-1], (n0, got)
