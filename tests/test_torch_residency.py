"""Tiered residency in the port (``pilosa_tpu_torch/parallel/residency.py``
and the residency half of ``TorchEngine``) against ``pilosa_tpu``'s
``MeshEngine`` on one mesh device, as ``tests/test_residency.py`` runs it.

The same seeded holder data goes through both engines under one
``max_resident_bytes``, sized so that a full stack does not fit: every
answer must equal the host lane's, and the residency outcomes the
reference test asserts (host fallbacks, partial promotions, evictions,
declines, the promoted working set) must be equal on both sides.  The
port's per-(row, shard) charge is the reference's ``_row_shard_bytes``, so
one budget makes the same decisions.  Then the ``rowb`` pool leaf's plain
version, and K1's, K5's and F1's plain versions over trees that mix pool
and stack leaves, against the reference's ``apply_prog`` (JAX on the CPU).

The cases of ``tests/test_residency.py`` that hang off the plan ledger
and the prefetch advisor run here against the reference too: the ledger's
cost EWMA as the default eviction price (``:288``), the warm start's
hottest-tenant-first order (``:301``), the host-fallback plan annotation
(``:360``), a write during a promote-ahead promotion (``:418``) and
next-touch eviction by the advisor's prediction (``:460``).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu import pql as jpql
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.parallel import advisor as jadvisor
from pilosa_tpu.parallel import kernels as jkernels
from pilosa_tpu.util import plans as jplans
from pilosa_tpu.util.events import EventJournal as JJournal
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.parallel import advisor as tadvisor
from pilosa_tpu_torch.parallel import kernels
from pilosa_tpu_torch.parallel import residency as residency_mod
from pilosa_tpu_torch.parallel.engine import ROW_SHARD_BYTES, TorchEngine
from pilosa_tpu_torch.parallel.errors import (HostFallback, PeerlessMeshError, ResidencyMiss,
                                              UnsupportedLowering)
from pilosa_tpu_torch.util import plans as tplans
from pilosa_tpu_torch.util.events import EventJournal as TJournal
from pilosa_tpu_torch.util.stats import REGISTRY

# One (row, shard) of device words plus the occupancy and resident-block
# summaries: the reference's sizing unit (tests/test_residency.py).
ROW_SHARD = 32768 * 4 + 16
N_ROWS = 16

QUERIES = [
    "Count(Intersect(Row(f=10), Row(f=11)))",
    "Count(Union(Row(f=10), Row(f=11)))",
    "Count(Difference(Row(f=11), Row(f=10)))",
    "Count(Xor(Row(f=10), Row(f=11)))",
]


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1)


def build_oversub(holder, n_rows=N_ROWS):
    """One shard, ``n_rows`` rows of distinct overlapping bit sets: a full
    stack of n_rows * ROW_SHARD bytes (tests/test_residency.py)."""
    idx = holder.create_index("i")
    f = idx.create_field("f")
    rows, cols = [], []
    for r in range(n_rows):
        for c in range(0, 400 + 10 * r, 2):
            rows.append(r)
            cols.append(c)
    f.import_bulk(rows, cols)
    return idx


class Side:
    """One engine's side of a differential: its holder, engine, executor
    and an engine-less executor (the host lane, the truth)."""

    def __init__(self, name, holder, engine, ex, host, pql, field_options):
        self.name = name
        self.holder = holder
        self.engine = engine
        self.ex = ex
        self.host = host
        self.pql = pql
        self.FieldOptions = field_options

    def q(self, query):
        got = self.ex.execute("i", query).results
        want = self.host.execute("i", query).results
        assert got == want, (self.name, query, got, want)
        return got[0] if len(got) == 1 else got

    def stack(self, field="f", view="standard"):
        return self.engine._stacks.get(("i", field, view))

    def snap(self):
        return self.engine.residency.snapshot()

    def evictions(self):
        return self.engine.cache_snapshot()["evictions"]

    def flush(self):
        assert self.engine.residency.flush(30.0), self.name


def make_sides(mesh1, budget, build=build_oversub, **kw):
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    build(jh, **kw)
    build(th, **kw)
    je = MeshEngine(jh, mesh1, max_resident_bytes=budget)
    te = TorchEngine(th, device="cpu", max_resident_bytes=budget)
    for e in (je, te):
        e.result_memo.maxsize = 0  # every query consults residency
    return [
        Side("jax", jh, je, JExecutor(jh, mesh_engine=je), JExecutor(jh), jpql, JFieldOptions),
        Side("torch", th, te, Executor(th, engine=te), Executor(th), tpql, TFieldOptions),
    ]


def close(sides):
    for s in sides:
        s.engine.close()


def same(sides, fn):
    """fn(side) on both sides, asserted equal; the common value."""
    vals = [fn(s) for s in sides]
    assert vals[0] == vals[1], vals
    return vals[0]


def test_row_shard_charge_matches_reference():
    assert ROW_SHARD_BYTES == ROW_SHARD == MeshEngine._row_shard_bytes()


def test_cold_miss_host_fallback_then_partial_promotion(mesh1):
    sides = make_sides(mesh1, 4 * ROW_SHARD + 4096)
    q = QUERIES[0]
    for s in sides:
        s.q(q)  # cold: ResidencyMiss, host lane, promotion requested
    assert same(sides, lambda s: s.engine.host_fallbacks) >= 1
    for s in sides:
        s.flush()
    assert same(sides, lambda s: s.snap()["partialPromotions"]) >= 1
    assert same(sides, lambda s: s.snap()["promotedBytes"]) > 0
    fb = same(sides, lambda s: s.engine.host_fallbacks)
    jd, td = sides[0].engine.fused_dispatches, sides[1].engine.dense_dispatches
    for s in sides:
        s.q(q)  # warm: on the device, from the pool
    assert same(sides, lambda s: s.engine.host_fallbacks) == fb
    assert sides[0].engine.fused_dispatches > jd
    assert sides[1].engine.dense_dispatches > td
    assert sides[1].engine.last_path == "dense"  # a pool leaf takes K1
    for s in sides:
        st = s.stack()
        assert st.partial and st.pool
        assert 0.0 < st.resident_fraction() < 1.0
        assert not np.any(st.occ & ~st.block_mask)  # mask >= occ
    assert same(sides, lambda s: s.stack().resident_fraction())
    assert same(sides, lambda s: sorted(s.stack().row_index))
    assert same(sides, lambda s: {r: v.tolist() for r, v in s.stack().slot_of.items()})
    assert same(sides, lambda s: tuple(s.stack().matrix.shape))
    assert same(sides, lambda s: s.stack().footprint)
    close(sides)


def test_differential_full_partial_host(mesh1):
    """Exact answers across the fully resident, partially resident and
    host paths for the same queries."""
    full = make_sides(mesh1, 64 * ROW_SHARD)
    part = make_sides(mesh1, 4 * ROW_SHARD + 4096)
    for q in QUERIES:
        assert same(full, lambda s: s.q(q)) == same(part, lambda s: s.q(q))
    for s in part:
        s.flush()
    for q in QUERIES:
        assert same(full, lambda s: s.q(q)) == same(part, lambda s: s.q(q))
    for s in part:
        assert s.stack().partial
    assert same(full, lambda s: s.engine.host_fallbacks) == 0
    assert same(part, lambda s: s.snap()["partialPromotions"]) >= 1
    close(full + part)


def test_uncovered_row_grows_working_set(mesh1):
    sides = make_sides(mesh1, 8 * ROW_SHARD + 4096)
    for s in sides:
        s.q(QUERIES[0])
        s.flush()
    assert same(sides, lambda s: set(s.stack().row_index)) == {10, 11}
    q2 = "Count(Intersect(Row(f=2), Row(f=3)))"
    fb0 = same(sides, lambda s: s.engine.host_fallbacks)
    for s in sides:
        s.q(q2)
    assert same(sides, lambda s: s.engine.host_fallbacks) > fb0
    for s in sides:
        s.flush()
    assert same(sides, lambda s: set(s.stack().row_index)) >= {2, 3, 10, 11}
    fb1 = same(sides, lambda s: s.engine.host_fallbacks)
    for s in sides:
        s.q(q2)
        s.q(QUERIES[1])  # the old rows stayed
    assert same(sides, lambda s: s.engine.host_fallbacks) == fb1
    close(sides)


def test_absent_row_zero_then_write_invalidates(mesh1):
    """A promoted row that is empty everywhere lowers to the zero slot
    vector; a write that creates it drops the marker in the sync, so the
    next query misses and promotes instead of reading a stale zero."""
    sides = make_sides(mesh1, 4 * ROW_SHARD + 4096)
    q = "Count(Intersect(Row(f=99), Row(f=10)))"
    assert same(sides, lambda s: s.q(q)) == 0
    for s in sides:
        s.flush()
        assert 99 in s.stack().absent_rows
    fb0 = same(sides, lambda s: s.engine.host_fallbacks)
    assert same(sides, lambda s: s.q(q)) == 0
    assert same(sides, lambda s: s.engine.host_fallbacks) == fb0
    for s in sides:
        s.holder.index("i").field("f").import_bulk([99, 99], [0, 2])
    assert same(sides, lambda s: s.q(q)) == 2
    for s in sides:
        s.flush()
    assert same(sides, lambda s: s.q(q)) == 2
    close(sides)


def test_write_during_promotion_token_recheck(mesh1):
    """A write landing during a promotion (after the chunk was read,
    before the commit) reconciles through the token re-check and the
    incremental sync: never the pre-write bits."""
    sides = make_sides(mesh1, 4 * ROW_SHARD + 4096)
    for s in sides:
        eng = s.engine
        orig = eng._assemble_pool_chunk
        wrote = threading.Event()
        idx = s.holder.index("i")

        def racing(chunk_rows, row_index, slot_of, frags, occ, orig=orig, wrote=wrote,
                   idx=idx):
            out = orig(chunk_rows, row_index, slot_of, frags, occ)
            if not wrote.is_set():
                wrote.set()
                idx.field("f").import_bulk([10, 11], [100001, 100001])
            return out

        eng._assemble_pool_chunk = racing
        s.ex.execute("i", QUERIES[0])  # cold: host lane + promotion
        s.flush()
        assert wrote.is_set()
    for q in QUERIES:
        same(sides, lambda s: s.q(q))  # the post-write truth on both
    assert same(sides, lambda s: s.stack().partial)
    close(sides)


def _fused_entries(pql):
    return [
        ({"kind": "count", "call": pql.parse("Intersect(Row(f=0), Row(f=1))").calls[0]}, [0]),
        ({"kind": "count", "call": pql.parse("Union(Row(f=0), Row(f=1))").calls[0]}, [0]),
    ]


def test_eviction_under_cached_fused_plan(mesh1):
    """Evicting a stack a cached fused plan reads drops the plan, and the
    next drain answers the same."""
    sides = make_sides(mesh1, 64 * ROW_SHARD, n_rows=2)
    firsts = []
    for s in sides:
        eng = s.engine
        entries = _fused_entries(s.pql)
        first = eng.fused_many("i", entries)
        assert eng._fused_plans
        lock = getattr(eng, "_dispatch_lock", eng._stacks_lock)
        with lock, eng._stacks_lock:
            eng._evict_for(eng.max_resident_bytes)  # evicts everything
            assert not eng._stacks
        assert not eng._fused_plans
        assert eng.fused_many("i", entries) == first
        firsts.append(first)
    assert firsts[0] == firsts[1]
    close(sides)


def test_eviction_under_cached_fused_plan_over_a_pool(mesh1):
    """The same over a partial stack: a re-promotion (growth) replaces the
    pool a cached plan read, and the plan is dropped with it."""
    sides = make_sides(mesh1, 4 * ROW_SHARD + 4096)
    for s in sides:
        s.q(QUERIES[0])
        s.flush()
    t = sides[1]
    entries = [({"kind": "count", "call": tpql.parse(q[6:-1]).calls[0]}, [0])
               for q in QUERIES[:2]]
    want = [t.host.execute("i", q).results[0] for q in QUERIES[:2]]
    assert t.engine.fused_many("i", entries) == want
    assert t.engine._fused_plans
    t.q("Count(Intersect(Row(f=3), Row(f=10)))")  # a miss grows the pool
    t.flush()
    assert not t.engine._fused_plans
    assert t.engine.fused_many("i", entries) == want
    close(sides)


def test_admission_counts_summaries_and_inflight(mesh1):
    sides = make_sides(mesh1, 64 * ROW_SHARD, n_rows=2)
    for s in sides:
        eng = s.engine
        stack = eng.field_stack("i", "f", "standard")
        nbytes = stack.matrix.nbytes if s.name == "jax" else stack.matrix.numel() * 4
        assert stack.footprint > nbytes  # the occupancy summary counts
        assert eng._resident_bytes == stack.footprint
        assert eng._admissible(0)
        eng.residency.add_inflight(eng.max_resident_bytes)
        assert not eng._admissible(1)  # promotions in flight count
        eng.residency.sub_inflight(eng.max_resident_bytes)
        assert eng._admissible(0)
    assert same(sides, lambda s: s.stack().footprint)
    close(sides)


def _tenants(holder):
    for name in ("hot", "cold"):
        holder.create_index(name).create_field("f").import_bulk([1], [0])
    holder.index("hot").create_field("g").import_bulk([1], [0])


def test_cost_priced_eviction_prefers_cold_tenants(mesh1):
    """Admitting hot/g evicts the COLD tenant's stack, though hot/f is
    older in LRU order (the cost_of_index hook)."""
    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        h.open()
        _tenants(h)
    budget = 2 * ROW_SHARD + 4096
    engines = [MeshEngine(jh, mesh1, max_resident_bytes=budget),
               TorchEngine(th, device="cpu", max_resident_bytes=budget)]
    for eng in engines:
        eng.cost_of_index = lambda index: {"hot": 5.0}.get(index, 0.0)
        eng.field_stack("hot", "f", "standard")
        eng.field_stack("cold", "f", "standard")
        assert len(eng._stacks) == 2
        eng.field_stack("hot", "g", "standard")
        assert ("cold", "f", "standard") not in eng._stacks
        assert ("hot", "f", "standard") in eng._stacks
    assert list(engines[0]._stacks) == list(engines[1]._stacks)
    for eng in engines:
        eng.close()


def test_lru_eviction_without_costs(mesh1):
    """With no cost recorded for any tenant (an empty ledger under the
    default pricing) the port evicts least recently used first, as the
    reference does."""
    tplans.LEDGER.reset()
    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        h.open()
        _tenants(h)
    budget = 2 * ROW_SHARD + 4096
    engines = [MeshEngine(jh, mesh1, max_resident_bytes=budget),
               TorchEngine(th, device="cpu", max_resident_bytes=budget)]
    engines[0].cost_of_index = lambda index: 0.0
    for eng in engines:
        eng.field_stack("hot", "f", "standard")
        eng.field_stack("cold", "f", "standard")
        eng.field_stack("hot", "f", "standard")  # hot/f now most recent
        eng.field_stack("hot", "g", "standard")
        assert ("cold", "f", "standard") not in eng._stacks
    assert list(engines[0]._stacks) == list(engines[1]._stacks)
    assert engines[1].evictions == 1
    for eng in engines:
        eng.close()


def test_broken_cost_hook_never_fails_admission(mesh1):
    th = THolder(device="cpu")
    th.open()
    _tenants(th)
    eng = TorchEngine(th, device="cpu", max_resident_bytes=2 * ROW_SHARD + 4096)

    def boom(index):
        raise RuntimeError("pricing down")

    eng.cost_of_index = boom
    for key in (("hot", "f"), ("cold", "f"), ("hot", "g")):
        assert eng.field_stack(*key, "standard") is not None
    assert len(eng._stacks) == 2
    eng.close()


def _with_int_field(holder):
    idx = build_oversub(holder)
    FieldOptions = (TFieldOptions if isinstance(holder, THolder) else JFieldOptions)
    v = idx.create_field("v", FieldOptions(type="int", min=0, max=1000))
    v.import_values(list(range(50)), [int(3 * c) % 1000 for c in range(50)])
    return idx


@pytest.mark.parametrize("q", ["Sum(field=v)", "Min(field=v)", "Max(field=v)",
                               "Sum(Row(f=10), field=v)",
                               "Count(Intersect(Row(f=1), Range(v > 100)))",
                               "TopN(f, Row(f=10), n=3)", "TopN(f, n=4)"])
def test_aggregate_requires_full_stack(mesh1, q):
    """Aggregates over an oversubscribed stack (BSI planes, TopN
    candidates) are served from the host tier, exactly."""
    sides = make_sides(mesh1, 4 * ROW_SHARD + 4096, build=_with_int_field)
    for s in sides:
        s.q(q)
        s.flush()
        s.q(q)
    close(sides)


def test_groupby_requires_full_stack(mesh1):
    sides = make_sides(mesh1, 4 * ROW_SHARD + 4096)
    q = "GroupBy(Rows(field=f), filter=Row(f=10))"
    for s in sides:
        s.q(q)
        s.flush()
        s.q(q)
    close(sides)


def test_residency_miss_type_and_metrics_surface(mesh1):
    sides = make_sides(mesh1, 2 * ROW_SHARD + 4096)
    t = sides[1]
    assert issubclass(ResidencyMiss, PeerlessMeshError)
    assert issubclass(ResidencyMiss, HostFallback) and issubclass(UnsupportedLowering,
                                                                  HostFallback)
    for s in sides:
        with pytest.raises(Exception) as ei:
            s.engine.count("i", s.pql.parse("Intersect(Row(f=1), Row(f=2))").calls[0], [0])
        assert type(ei.value).__name__ == "ResidencyMiss"
        assert ei.value.key == ("i", "f", "standard")
        assert ei.value.resident_fraction == 0.0
    t.engine.refresh_metrics()
    text = REGISTRY.prometheus_text()
    for series in ("pilosa_engine_partial_promotions_total",
                   "pilosa_engine_promotions_declined_total",
                   "pilosa_engine_promoted_bytes_total",
                   "pilosa_engine_host_fallbacks_total",
                   "pilosa_engine_resident_block_fraction"):
        assert series in text, series
    for s in sides:
        snap = s.engine.cache_snapshot()
        assert snap["hostFallbacks"] >= 1
        assert "pendingPromotions" in snap["workingSet"]
        assert snap["workingSet"]["deviceBudgetBytes"] == s.engine.max_resident_bytes
    assert same(sides, lambda s: s.engine.host_fallbacks) == 1
    close(sides)


def test_block_pool_fuzz_promote_evict_sync(mesh1):
    """Rotating row pairs churn promotions and evictions under a 4-row
    budget while random writes land across the whole shard (new blocks,
    freed and reused slots): every answer exact on both sides."""
    rng = np.random.default_rng(7)
    sides = make_sides(mesh1, 4 * ROW_SHARD + 4096)
    ops = ("Intersect", "Union", "Difference", "Xor")
    for it in range(30):
        r1, r2 = (int(r) for r in rng.choice(N_ROWS, 2, replace=False))
        q = f"Count({ops[it % 4]}(Row(f={r1}), Row(f={r2})))"
        same(sides, lambda s: s.q(q))
        if it % 3 == 0:
            n = int(rng.integers(1, 6))
            rows = [int(r) for r in rng.integers(0, N_ROWS, n)]
            cols = [int(c) for c in rng.integers(0, 1_000_000, n)]
            for s in sides:
                s.holder.index("i").field("f").import_bulk(rows, cols)
        if it % 7 == 0:
            for s in sides:
                s.flush()
    for s in sides:
        s.flush()
        assert s.snap()["partialPromotions"] >= 1
        assert s.evictions() >= 1  # the churn was real
    for q in QUERIES:
        same(sides, lambda s: s.q(q))
    close(sides)


def test_pool_sync_sets_clears_and_recycles_a_slot(mesh1):
    """Writes into a promoted row sync in place (no rebuild): a Set into an
    empty block takes a fresh slot, a Clear that empties a block frees its
    slot, and the next new block reuses it (zeroed first)."""
    sides = make_sides(mesh1, 4 * ROW_SHARD + 4096)
    q = QUERIES[1]
    for s in sides:
        s.q(q)
        s.flush()
    t = sides[1]
    eng = t.engine
    st = t.stack()
    f = t.holder.index("i").field("f")
    rebuilds, updates = eng.stack_rebuilds, eng.stack_updates
    blk_cols = lambda b: b * 16384 + 7  # noqa: E731 — a column in block b
    f.import_bulk([10], [blk_cols(30)])  # block 30 was empty: a new slot
    assert t.q(q) == t.host.execute("i", q).results[0]
    assert eng.stack_updates == updates + 1 and eng.stack_rebuilds == rebuilds
    slot30 = int(st.slot_of[10][30])
    assert slot30 >= 1
    t.ex.execute("i", f"Clear({blk_cols(30)}, f=10)")
    assert t.q(q) == t.host.execute("i", q).results[0]
    assert int(st.slot_of[10][30]) == 0 and slot30 in st.free_dirty
    # New blocks take the never-written slots first, then the freed one.
    virgin = int(st.matrix.shape[0]) - st.pool_next
    f.import_bulk([11] * (virgin + 1), [blk_cols(40 + k) for k in range(virgin + 1)])
    assert t.q(q) == t.host.execute("i", q).results[0]
    assert st.pool_next == st.matrix.shape[0] and not st.free_dirty
    assert int(st.slot_of[11][40 + virgin]) == slot30
    assert eng.stack_rebuilds == rebuilds and eng._stacks[("i", "f", "standard")] is st
    assert int(st.matrix[0].abs().sum()) == 0  # slot 0 stays zero
    table = st.slot_table.numpy()
    assert table[st.row_index[11], 40 + virgin] == slot30 and not table[-1].any()
    for q2 in QUERIES:
        t.q(q2)
    close(sides)


def test_pool_exhaustion_rebuilds_at_a_bigger_tier(mesh1):
    """More new blocks than the pool has slots: the sync gives up, the
    stack misses and re-promotes at a bigger capacity, answers exact."""
    sides = make_sides(mesh1, 8 * ROW_SHARD + 4096)
    q = QUERIES[1]
    for s in sides:
        s.q(q)
        s.flush()
    cap = same(sides, lambda s: int(s.stack().matrix.shape[0]))
    cols = [b * 16384 + 5 for b in range(1, 64)]
    for s in sides:
        s.holder.index("i").field("f").import_bulk([10] * len(cols), cols)
        s.q(q)  # out of slots: a miss
        s.flush()
        s.q(q)
    assert same(sides, lambda s: int(s.stack().matrix.shape[0])) > cap
    close(sides)


def test_promotion_declined_cooldown(mesh1):
    """A budget below the smallest pool declines (counted) and cools down;
    the host tier keeps serving exactly."""
    sides = make_sides(mesh1, 4096)
    q = QUERIES[0]
    for s in sides:
        s.q(q)
        s.flush()
        deadline = time.monotonic() + 10.0
        while s.snap()["declined"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert s.snap()["declined"] >= 1
        assert s.snap()["cooldowns"] >= 1
        s.q(q)
    assert same(sides, lambda s: s.snap()["declined"]) == 1
    close(sides)


class _StubEngine:
    def __init__(self):
        self.calls = []
        self.gate = threading.Event()

    def _promote(self, key, rows, cause="reactive", trace_id=""):
        self.gate.wait(5)
        self.calls.append((key, None if rows is None else sorted(rows), cause))
        return "partial", 2048

    def _log(self, msg):
        pass


def test_manager_coalesces_and_none_absorbs():
    eng = _StubEngine()
    mgr = residency_mod.ResidencyManager(eng)
    k1, k2 = ("i", "f", "standard"), ("i", "g", "standard")
    mgr.request(("i", "z", "standard"), {0})  # the worker takes it, blocks
    time.sleep(0.05)
    assert mgr.request(k1, {1, 2})
    assert mgr.request(k1, {3})  # merges
    assert mgr.request(k2, {5})
    assert mgr.request(k2, None)  # None absorbs any row set
    assert mgr.request(k2, {6})
    eng.gate.set()
    assert mgr.flush(5)
    got = {c[0]: c[1] for c in eng.calls}
    assert got[k1] == [1, 2, 3] and got[k2] is None
    snap = mgr.snapshot()
    assert snap["partialPromotions"] == 3 and snap["promotedBytes"] == 3 * 2048
    mgr.close()


def test_manager_bounds_the_queue_and_cools_down_declines():
    class Decliner(_StubEngine):
        def _promote(self, key, rows, cause="reactive", trace_id=""):
            self.gate.wait(5)
            return "declined", 0

    eng = Decliner()
    mgr = residency_mod.ResidencyManager(eng)
    mgr.request(("x", "f", "standard"), None)
    time.sleep(0.05)  # the worker holds it
    for i in range(residency_mod.MAX_PENDING):
        assert mgr.request((f"i{i}", "f", "standard"), {i})
    assert not mgr.request(("over", "f", "standard"), {0})
    assert mgr.snapshot()["dropped"] == 1
    eng.gate.set()
    assert mgr.flush(10)
    # A declined FULL request cools down, but not for a row-hinted one.
    assert not mgr.request(("x", "f", "standard"), None)
    assert mgr.request(("x", "f", "standard"), {1})
    assert mgr.flush(5)
    # A declined partial one cools everything down.
    assert not mgr.request(("i0", "f", "standard"), {0})
    assert not mgr.request(("i0", "f", "standard"), None)
    assert mgr.snapshot()["cooldowns"] >= 1
    mgr.close()


def test_manager_inflight_accounting_and_close():
    mgr = residency_mod.ResidencyManager(_StubEngine())
    mgr.add_inflight(100)
    mgr.add_inflight(50)
    mgr.sub_inflight(120)
    assert mgr.inflight_bytes() == 30
    mgr.sub_inflight(1000)
    assert mgr.inflight_bytes() == 0
    mgr.close()
    assert not mgr.request(("i", "f", "standard"), {1})


def test_warm_start_stops_at_target(mesh1):
    """Warm start admits up to WARM_TARGET_FRACTION of the budget and
    stops there (the stop half of tests/test_residency.py:301; the
    hottest-tenant-first half is ``test_warm_start_orders_by_cost``)."""
    th = THolder(device="cpu")
    th.open()
    for name in ("aa", "bb", "cc"):
        th.create_index(name).create_field("f").import_bulk([1], [0])
    eng = TorchEngine(th, device="cpu", max_resident_bytes=int(2.5 * ROW_SHARD / 0.9))
    state = eng.warm_start()
    assert state["done"] and state["built"] == 2
    assert state["skipped"] == state["total"] - 2
    assert eng._resident_bytes <= eng.warm_target_bytes()
    eng.close()


def test_default_budget_on_the_cpu_is_unbounded():
    th = THolder(device="cpu")
    th.open()
    eng = TorchEngine(th, device="cpu")
    assert eng.max_resident_bytes >= 1 << 60
    assert TorchEngine(th, device="cpu", max_resident_bytes=0).max_resident_bytes >= 1 << 60
    assert TorchEngine(th, device="cpu", max_resident_bytes=12345).max_resident_bytes == 12345


def test_batched_counts_over_a_pool(mesh1):
    """count_many over pool rows is one K5 batch (plain on the CPU); a
    batch holding an uncovered row misses whole, and the executor serves
    every Count of the query exactly."""
    sides = make_sides(mesh1, 8 * ROW_SHARD + 4096)
    t = sides[1]
    t.q(QUERIES[0])
    t.flush()
    calls = [tpql.parse(q[6:-1]).calls[0] for q in QUERIES]
    d0 = t.engine.batch_dispatches
    got = t.engine.count_many("i", calls, [[0]] * len(calls))
    assert got == [t.host.execute("i", q).results[0] for q in QUERIES]
    assert t.engine.batch_dispatches == d0 + 1
    multi = "".join(QUERIES) + "Count(Intersect(Row(f=4), Row(f=10)))"
    assert t.q(multi)  # a miss inside the run: the host lane answers all
    t.flush()
    fb = t.engine.host_fallbacks
    t.q(multi)
    assert t.engine.host_fallbacks == fb
    close(sides)


def test_fused_drain_over_a_pool_and_a_miss(mesh1):
    """A fused drain over pool rows runs its Counts on F1's plain version;
    an item touching an uncovered row fails alone with ResidencyMiss."""
    sides = make_sides(mesh1, 8 * ROW_SHARD + 4096)
    t = sides[1]
    t.q(QUERIES[0])
    t.flush()
    seg = "Intersect(Row(f=10), Row(f=11))"
    entries = [
        ("i", {"kind": "count", "call": tpql.parse(f"Union({seg}, Row(f=10))").calls[0]}, [0]),
        ("i", {"kind": "count", "call": tpql.parse(f"Difference(Row(f=11), {seg})").calls[0]},
         [0]),
        ("i", {"kind": "count", "call": tpql.parse("Row(f=5)").calls[0]}, [0]),
    ]
    fd = t.engine.fused_drain_async(entries)
    parts = fd.dev.cpu().numpy()
    want = [t.host.execute("i", f"Count({q})").results[0]
            for q in (f"Union({seg}, Row(f=10))", f"Difference(Row(f=11), {seg})")]
    from pilosa_tpu_torch.parallel.fusion import unpack
    unpacked = unpack(parts, fd.layout)
    assert [fd.decoders[i](unpacked) for i in range(2)] == want
    assert isinstance(fd.errors[2], ResidencyMiss)
    close(sides)


# -- the rowb leaf's plain versions against the reference's apply_prog --------

def _pool_case(seed, S=3, P=9, n_rows=4):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, (P, S, 512), dtype=np.uint64).astype(np.uint32)
    pool[0] = 0
    table = np.zeros((n_rows + 1, 64), dtype=np.int32)
    for r in range(n_rows):
        blocks = rng.choice(64, int(rng.integers(0, 12)), replace=False)
        table[r, blocks] = rng.integers(1, P, len(blocks))  # slots may repeat
    dense = rng.integers(0, 1 << 32, (3, S, 32768), dtype=np.uint64).astype(np.uint32)
    return pool, table, dense


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_row_matches_apply_prog_rowb(seed):
    pool, table, _ = _pool_case(seed)
    for r in range(table.shape[0]):
        want = np.asarray(jkernels.apply_prog(("rowb", 0, 1),
                                              [jnp.asarray(pool), jnp.asarray(table[r])]))
        got = kernels.pool_row(torch.from_numpy(pool.view(np.int32)), torch.from_numpy(table[r]))
        assert np.array_equal(got.numpy().view(np.uint32), want), r


def test_pool_row_of_one_slot_pool_is_zero():
    pool = torch.zeros((1, 2, 512), dtype=torch.int32)
    row = kernels.pool_row(pool, torch.zeros(64, dtype=torch.int32))
    assert row.shape == (2, 32768) and int(row.abs().sum()) == 0


TREES = [
    ("and", ("row", 0, 1), ("rowb", 1, 2, 0)),
    ("or", ("rowb", 1, 2, 1), ("rowb", 1, 2, 2), ("row", 0, 0)),
    ("andnot", ("rowb", 1, 2, 3), ("xor", ("row", 0, 2), ("rowb", 1, 2, 4))),
    ("xor", ("rowb", 1, 2, 0), ("rowb", 1, 2, 0)),
    ("rowb", 1, 2, 2),
]


def _ref_eval(tree, dense, pool, table):
    """The reference's apply_prog over the same operands: dense rows as
    ("row", 0, scalar operand), pool rows as ("rowb", 1, slot vector)."""
    ops = [jnp.asarray(dense), jnp.asarray(pool)]

    def conv(p):
        if p[0] == "row":
            ops.append(jnp.asarray(p[2], dtype=jnp.int32))
            return ("row", 0, len(ops) - 1)
        if p[0] == "rowb":
            ops.append(jnp.asarray(table[p[3]]))
            return ("rowb", 1, len(ops) - 1)
        return (p[0],) + tuple(conv(q) for q in p[1:])

    return np.asarray(jkernels.apply_prog(conv(tree), ops)).astype(np.uint32)


def _mats(dense, pool, table):
    return [torch.from_numpy(dense.view(np.int32)), torch.from_numpy(pool.view(np.int32)),
            torch.from_numpy(table)]


@pytest.mark.parametrize("tree", TREES)
def test_count_tree_plain_over_pool_leaves_matches_reference(tree):
    pool, table, dense = _pool_case(5)
    mask = np.array([1, 0, 1], dtype=np.int32)
    ref = _ref_eval(tree, dense, pool, table)
    want = int(np.unpackbits(ref[mask != 0].view(np.uint8)).sum())
    got = kernels.count_tree(tree, _mats(dense, pool, table), torch.from_numpy(mask))
    assert int(got) == want


def test_count_batch_plain_over_pool_leaves_matches_reference():
    pool, table, dense = _pool_case(6)
    masks = np.array([[1, 1, 1], [0, 1, 0]], dtype=bool)
    mask_ids = [i % 2 for i in range(len(TREES))]
    assert all(kernels.fits(t) for t in TREES)
    got = kernels.count_batch_tree(TREES, _mats(dense, pool, table), masks, mask_ids, "cpu")
    for k, tree in enumerate(TREES):
        ref = _ref_eval(tree, dense, pool, table)[masks[mask_ids[k]]]
        assert int(got[k]) == int(np.unpackbits(ref.view(np.uint8)).sum()), k
    batch = kernels.compile_batch(TREES, mask_ids)
    assert {leaf for leaf in batch.leaves if len(leaf) == 3} == {(1, r, 2) for r in range(5)}


def test_fused_plain_over_pool_leaves_matches_reference():
    pool, table, dense = _pool_case(7)
    slots = (("and", ("row", 0, 1), ("rowb", 1, 2, 0)),
             ("or", ("mref", 0), ("rowb", 1, 2, 1)),
             ("xor", ("mref", 1), ("rowb", 1, 2, 4), ("row", 0, 2)))
    masks = [torch.tensor([1, 1, 1], dtype=torch.int32), torch.tensor([1, 0, 0], dtype=torch.int32)]
    spec = kernels.FusedSpec(slots, [(0, 0), (1, 1), (2, 0)], [])
    got = kernels.fused_tree(spec, _mats(dense, pool, table), masks)[0].tolist()
    # The reference's fused slots: apply_prog with the evaluated table.
    ops = [jnp.asarray(dense), jnp.asarray(pool), jnp.asarray(1, dtype=jnp.int32),
           jnp.asarray(2, dtype=jnp.int32)]
    for r in range(table.shape[0]):
        ops.append(jnp.asarray(table[r]))
    conv = {("row", 0, 1): ("row", 0, 2), ("row", 0, 2): ("row", 0, 3)}

    def c(p):
        if p[0] == "row":
            return conv[p]
        if p[0] == "rowb":
            return ("rowb", 1, 4 + p[3])
        if p[0] == "mref":
            return p
        return (p[0],) + tuple(c(q) for q in p[1:])

    ref_slots = []
    for prog in slots:
        ref_slots.append(jkernels.apply_prog(c(prog), ops, ref_slots))
    want = []
    for j, m in spec.count_edges:
        row = np.asarray(ref_slots[j]).astype(np.uint32)[masks[m].numpy() != 0]
        want.append(int(np.unpackbits(row.view(np.uint8)).sum()))
    assert got == want
    code = spec.code()
    assert {leaf for leaf in code.leaves if len(leaf) == 3} == {(1, 0, 2), (1, 1, 2), (1, 4, 2)}
    assert any((op & 0xFF) == kernels.OP_ROWB for op in code.items)


def test_compiled_pool_leaf_opcodes():
    code = kernels.compile_prog(TREES[0])
    assert code.ops[1] & 0xFF == kernels.OP_ROWB and code.leaves == [(0, 1), (1, 0, 2)]
    assert code.chain
    kernels.check_prog(code)
    with pytest.raises(ValueError):
        kernels.compile_prog(("rowb", 1, 2))  # a pool leaf names its table row


def test_check_stacks_takes_pools_beside_stacks():
    pool, table, dense = _pool_case(8)
    mats = _mats(dense, pool, table)
    with pytest.raises(ValueError, match="card"):  # CPU tensors never launch
        kernels.check_stacks(mats, 3, kernels.compile_prog(TREES[0]))


def test_concurrent_queries_writes_and_promotions_stay_exact():
    """Eight query threads and a writer against a 4-row budget while the
    worker promotes and evicts, the switch interval shortened: every
    answer equals the host lane's answer to the same query over the same
    data version (the writer holds its lock across each write and
    reads back under it, so queries between writes see a fixed state)."""
    import sys

    th = THolder(device="cpu")
    th.open()
    build_oversub(th)
    eng = TorchEngine(th, device="cpu", max_resident_bytes=4 * ROW_SHARD + 4096)
    eng.result_memo.maxsize = 0
    ex, host = Executor(th, engine=eng), Executor(th)
    lock = threading.RLock()
    errors, done = [], threading.Event()

    def reader(seed):
        rng = np.random.default_rng(seed)
        ops = ("Intersect", "Union", "Difference", "Xor")
        while not done.is_set():
            r1, r2 = (int(r) for r in rng.choice(N_ROWS, 2, replace=False))
            q = f"Count({ops[int(rng.integers(4))]}(Row(f={r1}), Row(f={r2})))"
            with lock:
                got = ex.execute("i", q).results[0]
                want = host.execute("i", q).results[0]
            if got != want:
                errors.append((q, got, want))

    def writer():
        rng = np.random.default_rng(99)
        for _ in range(40):
            with lock:
                th.index("i").field("f").import_bulk(
                    [int(r) for r in rng.integers(0, N_ROWS, 3)],
                    [int(c) for c in rng.integers(0, 1 << 20, 3)])
            time.sleep(0.005)
        done.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
        threads.append(threading.Thread(target=writer))
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        done.set()
    assert not errors, errors[:3]
    assert eng.residency.flush(30.0)
    assert eng.residency.snapshot()["partialPromotions"] >= 1
    for q in QUERIES:
        assert ex.execute("i", q).results[0] == host.execute("i", q).results[0]
    eng.close()


# -- the plan ledger's pricing and the prefetch advisor (tests/test_residency.py
# :288, :301, :360, :418, :460) --------------------------------------------------


def test_ledger_cost_ewma_feeds_default_pricing(mesh1):
    """The default eviction price is the plan ledger's per-tenant cost EWMA
    (tests/test_residency.py:288)."""
    jh, th = JHolder(), THolder(device="cpu")
    engines = []
    for h, mod in ((jh, jplans), (th, tplans)):
        h.open()
        h.create_index("t1").create_field("f").import_bulk([1], [0])
        mod.LEDGER.reset()
        mod.LEDGER.seed_costs({"t1": 0.25, "bad": "x", "zero": 0.0})
    engines = [MeshEngine(jh, mesh1), TorchEngine(th, device="cpu")]
    try:
        for eng in engines:
            assert eng._index_cost("t1") == 0.25
            assert eng._index_cost("unknown") == 0.0
        assert tplans.LEDGER.ewma_snapshot() == jplans.LEDGER.ewma_snapshot() == {"t1": 0.25}
        # A live signal is never overwritten by a seed.
        tplans.LEDGER.seed_costs({"t1": 9.0})
        assert tplans.LEDGER.cost_ewma("t1") == 0.25
    finally:
        for mod in (jplans, tplans):
            mod.LEDGER.reset()
        for eng in engines:
            eng.close()


def test_warm_start_orders_by_cost(mesh1):
    """Warm start builds the hottest tenant first and stops at the target
    (tests/test_residency.py:301): the same stacks in the same order."""
    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        h.open()
        for name in ("aa", "bb", "cc"):
            h.create_index(name).create_field("f").import_bulk([1], [0])
    budget = int(2.5 * ROW_SHARD / 0.9)
    engines = [MeshEngine(jh, mesh1, max_resident_bytes=budget),
               TorchEngine(th, device="cpu", max_resident_bytes=budget)]
    states = []
    for eng in engines:
        eng.cost_of_index = lambda index: {"bb": 9.0, "cc": 1.0}.get(index, 0.0)
        states.append(eng.warm_start())
    assert states[1] == states[0]
    assert states[1]["built"] == 2 and states[1]["skipped"] == states[1]["total"] - 2
    assert [k[0] for k in engines[1]._stacks] == [k[0] for k in engines[0]._stacks] == ["bb", "cc"]
    for eng in engines:
        eng.close()


def test_host_fallback_plan_annotation(mesh1):
    """A miss stamps the plan note the analyzer renders as "host fallback:
    stack NN% resident" (tests/test_residency.py:360), with the same notes
    and touches as the reference's."""
    sides = make_sides(mesh1, 2 * ROW_SHARD + 4096)
    plans = []
    for s, mod in zip(sides, (jplans, tplans)):
        mod.take_dispatch_note()
        plan = mod.begin("i", QUERIES[0], tenant="i")
        with mod.attach(plan):
            s.q(QUERIES[0])
        plans.append(plan)
    notes = [mod.analyze(p) for mod, p in zip((jplans, tplans), plans)]
    assert notes[1] == notes[0]
    assert any("host fallback" in n and "resident" in n for n in notes[1]), notes[1]
    fb = [[o.get("touches") for o in p.ops if o.get("path") == "host_fallback"] for p in plans]
    assert fb[1] == fb[0] and fb[1]
    close(sides)


def test_write_during_promote_ahead_race(mesh1):
    """A write landing during an advisor-driven promotion reconciles as a
    demand one does (the token re-check and the in-place sync), and the
    journal records the promotion with cause "advisor"
    (tests/test_residency.py:418)."""
    sides = make_sides(mesh1, 4 * ROW_SHARD + 4096)
    journals = [JJournal(), TJournal()]
    for s, journal in zip(sides, journals):
        s.engine.journal = journal
        orig = s.engine._assemble_pool_chunk
        wrote = threading.Event()

        def racing(chunk_rows, row_index, slot_of, frags, occ, orig=orig, wrote=wrote, s=s):
            out = orig(chunk_rows, row_index, slot_of, frags, occ)
            if not wrote.is_set():
                wrote.set()
                s.holder.index("i").field("f").import_bulk([10, 11], [100001, 100001])
            return out

        s.engine._assemble_pool_chunk = racing
        assert s.engine.residency.request(("i", "f", "standard"), {10, 11}, cause="advisor")
        s.flush()
        assert wrote.is_set()
        promos = journal.events(type="engine.promotion")
        assert [e.fields.get("cause") for e in promos] == ["advisor"]
    # The first query reconciles through the token gate and answers the
    # write's truth (Side.q holds it to the host lane).
    assert same(sides, lambda s: s.q(QUERIES[0])) > 0
    assert same(sides, lambda s: sorted(s.stack().row_index)) == [10, 11]
    close(sides)


def test_next_touch_eviction_prefers_predicted_stack(mesh1):
    """With no outstanding advice the price is cost then LRU (the cheapest
    tenant goes); with advice naming a stack, that stack survives and the
    other goes instead (tests/test_residency.py:460), on both sides."""
    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        h.open()
        for name in ("p1", "p2"):
            h.create_index(name).create_field("f").import_bulk([1], [0])
        h.index("p1").create_field("g").import_bulk([1], [0])
    costs = {"p1": 0.0, "p2": 5.0}
    budget = 2 * ROW_SHARD + 4096

    def admit_third(make):
        eng = make()
        eng.cost_of_index = lambda index: costs.get(index, 0.0)
        eng.field_stack("p1", "f", "standard")
        eng.field_stack("p2", "f", "standard")
        assert len(eng._stacks) == 2
        eng.field_stack("p1", "g", "standard")
        keys = list(eng._stacks)
        eng.close()
        return keys

    makers = (lambda: MeshEngine(jh, mesh1, max_resident_bytes=budget),
              lambda: TorchEngine(th, device="cpu", max_resident_bytes=budget))
    try:
        for mod in (jadvisor, tadvisor):
            mod.ADVISOR.reset()
        cold = [admit_third(m) for m in makers]
        assert cold[1] == cold[0]
        assert ("p1", "f", "standard") not in cold[1] and ("p2", "f", "standard") in cold[1]
        for mod in (jadvisor, tadvisor):
            with mod.ADVISOR._lock:
                mod.ADVISOR._outstanding = ("sig", 1.0, {("p1", "f", "standard"): frozenset({1})})
        advised = [admit_third(m) for m in makers]
        assert advised[1] == advised[0]
        assert ("p1", "f", "standard") in advised[1]
        assert ("p2", "f", "standard") not in advised[1]
    finally:
        for mod in (jadvisor, tadvisor):
            mod.ADVISOR.reset()
