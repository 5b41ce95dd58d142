"""The slab TopN lane (K9) in the port against the JAX package.

- ``kernels.topn_slab_tree_plain`` (K9's plain version) equals the JAX
  program ``pilosa_tpu.parallel.kernels.topn_slab_tree`` on the 8-device
  CPU mesh, at S = 16 shards and K_pad 8 to 64, on adversarial scores and
  cache counts: ties in count and in score, fewer qualifiers than n,
  qualifiers past the slab (qual > k_out), candidates absent from a shard's
  cache (count 0), unrequested shards, thresholds at and above the scores,
  n = 0.  Scores are made exact by giving each candidate row of each shard
  exactly that many leading bits and the src row all ones.
- ``slab_select_plain`` alone against a direct transcription of
  ``fragment.top``'s heap walk per shard, on scores at most their counts
  (the closed form's premise).
- ``TorchEngine.topn_device_full`` equals ``MeshEngine.topn_device_full``
  (declines included) and the host walk on one seeded index built in both
  packages, with its declines counted by reason.

Counts are integers: exact agreement (tolerance 0).  K9 runs only on the
card (chip_smoke.py holds it against the plain version there); here the
wrapper takes the plain version because the tensors lie on the CPU."""

import heapq

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pilosa_tpu import pql as jpql
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.parallel import kernels as jk
from pilosa_tpu.parallel.mesh import SHARD_AXIS, put_global
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.parallel import kernels
from pilosa_tpu_torch.parallel.engine import TorchEngine

S = 16
W = 64  # words a shard row: 2048 columns, enough for every score below


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def _rows_with(scores: np.ndarray) -> np.ndarray:
    """uint32[K, S, W] rows whose (k, s) row holds scores[k, s] set bits,
    so against an all-ones src its score is exactly scores[k, s]."""
    bits = np.arange(W * 32)[None, None, :] < scores[:, :, None]
    return np.packbits(bits, axis=-1, bitorder="little").view("<u4")


def _reference(mesh, cand, cnt, mask_rows, thr, n_sel, k_out):
    K = cand.shape[0]
    src = np.full((1, S, W), 0xFFFFFFFF, dtype=np.uint32)
    mask = np.zeros((S, 1), dtype=np.uint32)
    mask[mask_rows, 0] = 0xFFFFFFFF
    ops = (put_global(mesh, src, P(None, SHARD_AXIS)), jnp.int32(0))
    vals, idx, qual = jk.topn_slab_tree(
        mesh, ("row", 0, 1), (P(None, SHARD_AXIS), P()), n_sel, k_out, tuple(range(K)),
        put_global(mesh, mask, P(SHARD_AXIS)), put_global(mesh, cand, P(None, SHARD_AXIS)),
        put_global(mesh, cnt, P(None, SHARD_AXIS)), jnp.int32(thr), *ops)
    return np.asarray(vals), np.asarray(idx), np.asarray(qual)


def _port(cand, cnt, mask_rows, thr, n_sel, k_out):
    K = cand.shape[0]
    src = torch.full((1, S, W), -1, dtype=torch.int32)
    mask = torch.zeros(S, dtype=torch.int32)
    mask[list(mask_rows)] = -1
    out = kernels.topn_slab_tree(
        ("row", 0, 0), [src], mask, torch.from_numpy(cand.view(np.int32)),
        torch.arange(K, dtype=torch.int32), torch.from_numpy(cnt), thr, n_sel, k_out)
    return tuple(t.numpy() for t in out)


def _case(rng, K_pad, kind):
    """(scores, cnt) int32[K_pad, S] for one adversarial kind."""
    if kind == "ties":  # few distinct counts and scores: every tie-break decides
        cnt = rng.choice([0, 3, 7, 7, 12], size=(K_pad, S)).astype(np.int32)
        scores = rng.choice([0, 1, 3, 3, 5], size=(K_pad, S)).astype(np.int32)
    elif kind == "sparse":  # most candidates absent from a shard's cache
        cnt = np.where(rng.random((K_pad, S)) < 0.8, 0, rng.integers(1, 50, (K_pad, S)))
        scores = rng.integers(0, 40, (K_pad, S))
    elif kind == "wide":  # distinct values: every candidate qualifies
        cnt = rng.integers(100, 2000, (K_pad, S))
        scores = rng.integers(50, 100, (K_pad, S))
    else:  # "mixed"
        cnt = rng.integers(0, 300, (K_pad, S))
        scores = np.minimum(cnt, rng.integers(0, 300, (K_pad, S)))
    return scores.astype(np.int32), cnt.astype(np.int32)


CASES = [(K_pad, kind) for K_pad in (8, 16, 64) for kind in ("ties", "sparse", "wide", "mixed")]


@pytest.mark.parametrize("K_pad,kind", CASES)
def test_slab_plain_equals_the_jax_program(mesh, K_pad, kind):
    rng = np.random.default_rng(K_pad * 7 + len(kind))
    scores, cnt = _case(rng, K_pad, kind)
    cand = _rows_with(scores)
    every = list(range(S))
    some = sorted(rng.choice(S, size=5, replace=False).tolist())
    checked = 0
    # n_sel and k_out are the JAX program's static arguments (one compile
    # each); thresholds and masks are data.
    for n_sel in (0, 2, K_pad):
        for thr in (1, 3, 6, 10_000):
            for mask_rows in (every, some):
                k_out = min(K_pad, max(8, 1 << (max(2 * n_sel, 8) - 1).bit_length()))
                for ko in sorted({k_out, K_pad}):
                    want = _reference(mesh, cand, cnt, mask_rows, thr, n_sel, ko)
                    got = _port(cand, cnt, mask_rows, thr, n_sel, ko)
                    for w, g in zip(want, got):
                        np.testing.assert_array_equal(g, w, err_msg=f"{n_sel} {thr} {ko}")
                    checked += 1
    assert checked >= 24


def _walk(scores, cnt, thr, n_sel):
    """fragment.top's heap walk (Fragment.top, fragment.go :1018-1106)
    over one shard's cached pairs in (count desc, id desc) order, with the
    candidates id-descending so that is (count desc, position asc): the
    set it emits as {position: score}."""
    K = len(cnt)
    order = sorted((k for k in range(K) if cnt[k] > 0), key=lambda k: (-cnt[k], k))
    heap, out = [], {}
    for k in order:
        c, sc = int(cnt[k]), int(scores[k])
        if c < thr:
            continue
        if not n_sel or len(heap) < n_sel:
            if sc == 0 or sc < thr:
                continue
        else:
            if heap[0] < thr or c < heap[0]:
                break
            if sc < heap[0]:
                continue
        heapq.heappush(heap, sc)
        out[k] = sc
    return out


@pytest.mark.parametrize("seed", range(6))
def test_slab_select_is_the_heap_walk(seed):
    rng = np.random.default_rng(100 + seed)
    K = 32
    for kind in ("ties", "sparse", "mixed"):
        scores, cnt = _case(rng, K, kind)
        # A score is at most its row's count: the closed form rests on it
        # (pilosa_tpu/parallel/kernels.py:399-426).
        scores = np.minimum(scores, cnt)
        for n_sel in (1, 3, 8):
            for thr in (1, 4):
                vals, idx, qual = kernels.slab_select_plain(
                    torch.from_numpy(scores), torch.from_numpy(cnt), thr, n_sel, K)
                for s in range(S):
                    want = _walk(scores[:, s], cnt[:, s], thr, n_sel)
                    got = {int(i): int(v) for v, i in zip(vals[s], idx[s]) if v > 0}
                    assert got == want and int(qual[s]) == len(want), (kind, n_sel, thr, s)


# -- the engine's lane ------------------------------------------------------------

N_SHARDS = 8


def _index(holder_cls, **kw):
    h = holder_cls(**kw)
    h.open()
    idx = h.create_index("i")
    t = idx.create_field("t")
    w = idx.create_field("w")
    rng = np.random.default_rng(5)
    rows, cols = [], []
    for s in range(N_SHARDS):
        base = s * bitops.SHARD_WIDTH
        for r in range(24):
            d = int(rng.integers(0, 90))
            for c in rng.choice(2048, size=d, replace=False):
                rows.append(r)
                cols.append(base + int(c))
        dup = rng.choice(2048, size=30, replace=False)
        for r in (40, 41, 42):  # equal bits: counts and scores tie
            rows += [r] * len(dup)
            cols += [base + int(c) for c in dup]
    t.import_bulk(rows, cols)
    wr, wc = [], []
    for s in range(N_SHARDS):
        base = s * bitops.SHARD_WIDTH
        for r, d in ((5, 1500), (6, 300)):
            for c in rng.choice(2048, size=d, replace=False):
                wr.append(r)
                wc.append(base + int(c))
    w.import_bulk(wr, wc)
    # Field u: twelve rows with equal bits in every shard, so with n = 1
    # (an 8-pair slab) all twelve qualify and every shard overflows.
    u = idx.create_field("u")
    ur, uc = [], []
    for s in range(N_SHARDS):
        same = rng.choice(2048, size=64, replace=False)
        for r in range(12):
            ur += [r] * len(same)
            uc += [s * bitops.SHARD_WIDTH + int(c) for c in same]
    u.import_bulk(ur, uc)
    return h


@pytest.fixture(scope="module")
def engines(mesh):
    jh = _index(JHolder)
    th = _index(THolder, device="cpu")
    je = MeshEngine(jh, mesh)
    te = TorchEngine(th, device="cpu")
    yield je, te
    je.close()
    te.close()


@pytest.mark.parametrize("src_row", [5, 6])
def test_topn_device_full_matches_the_reference_engine(engines, src_row):
    je, te = engines
    jsrc = jpql.parse(f"Row(w={src_row})").calls[0]
    tsrc = tpql.parse(f"Row(w={src_row})").calls[0]
    served = te.topn_slab_served
    declined = sum(te.topn_slab_declines.values())
    n_calls = 0
    for n in (1, 3, 64):
        for thr in (0, 4, 10_000_000):
            for shards in (list(range(N_SHARDS)), [0], [1, 4, 6]):
                want = je.topn_device_full("i", "t", jsrc, shards, n, thr)
                got = te.topn_device_full("i", "t", tsrc, shards, n, thr)
                assert got == want, (n, thr, shards)
                n_calls += 1
    assert te.topn_slab_served + sum(te.topn_slab_declines.values()) - served - declined \
        == n_calls
    assert te.topn_slab_served > served


def test_topn_device_full_declines_are_counted(engines):
    je, te = engines
    src = tpql.parse("Row(w=5)").calls[0]
    before = dict(te.topn_slab_declines)
    assert te.topn_device_full("i", "t", src, list(range(N_SHARDS)), 0, 1) is None
    assert te.topn_slab_declines["n0"] == before["n0"] + 1
    te.MAX_TOPN_CANDIDATES = 4
    try:
        assert te.topn_device_full("i", "t", src, list(range(N_SHARDS)), 3, 1) is None
    finally:
        del te.MAX_TOPN_CANDIDATES
    assert te.topn_slab_declines["candidates"] == before["candidates"] + 1
    assert te.topn_device_full("i", "u", src, list(range(N_SHARDS)), 1, 1) is None
    assert te.topn_slab_declines["overflow"] == before["overflow"] + 1
    jsrc = jpql.parse("Row(w=5)").calls[0]
    assert je.topn_device_full("i", "u", jsrc, list(range(N_SHARDS)), 1, 1) is None
    # n = 12 fits the twelve in a 32-pair slab: served, equal to the reference.
    got = te.topn_device_full("i", "u", src, list(range(N_SHARDS)), 12, 1)
    assert got is not None and got == je.topn_device_full(
        "i", "u", jsrc, list(range(N_SHARDS)), 12, 1)


def test_topn_device_full_counts_host_fallbacks(engines, monkeypatch):
    """A src tree without a device lowering and a stack off the card are
    declines too (the reference's executor catches them around the call):
    None, counted by reason."""
    from pilosa_tpu_torch.parallel.errors import ResidencyMiss

    _, te = engines
    before = dict(te.topn_slab_declines)
    src = tpql.parse("Row(nosuch=1)").calls[0]
    assert te.topn_device_full("i", "t", src, list(range(N_SHARDS)), 3, 1) is None
    assert te.topn_slab_declines["lowering"] == before["lowering"] + 1

    def miss(*a, **k):
        raise ResidencyMiss("not on the card")

    monkeypatch.setattr(te, "_lower_src", miss)
    src = tpql.parse("Row(w=5)").calls[0]
    assert te.topn_device_full("i", "t", src, list(range(N_SHARDS)), 3, 1) is None
    assert te.topn_slab_declines["residency"] == before["residency"] + 1
    assert te.topn_slab_declines["n0"] == before["n0"]


def test_env_switch_turns_the_lane_off(monkeypatch):
    """PILOSA_TOPN_SLAB=0 starts an engine with the lane off, as the
    reference's engine reads it; unset, the lane is on."""
    h = THolder(device="cpu")
    h.open()
    monkeypatch.setenv("PILOSA_TOPN_SLAB", "0")
    off = TorchEngine(h, device="cpu")
    monkeypatch.delenv("PILOSA_TOPN_SLAB")
    on = TorchEngine(h, device="cpu")
    try:
        assert not off.topn_slab_enabled and on.topn_slab_enabled
    finally:
        off.close()
        on.close()
        h.close()


class _Opt:
    remote = False


@pytest.mark.parametrize("q,slab", [("TopN(t, Row(w=6), n=16)", True),
                                    ("TopN(t, Row(w=5), n=3)", False),
                                    ("TopN(u, Row(w=5), n=1)", False),
                                    ("TopN(u, Row(w=5), n=12)", True)])
def test_mesh_topn_shards_slab_vs_host_walk(engines, q, slab):
    """The phase-1 routing: ``_mesh_topn_shards`` with the slab lane on
    returns what its host walk returns with the lane off (the oracle), and
    what the reference's returns with its own lane on and off; the plan
    note names the slab lane when it served.  Where it did not, a shard's
    slab overflowed (t's 27 candidates at n = 3, u's twelve equal rows at
    n = 1: 8-pair slabs) and the host walk served."""
    from pilosa_tpu.executor.executor import Executor as JExecutor
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.util import plans as plans_mod

    je, te = engines
    ex = Executor(te.holder, engine=te)
    jex = JExecutor(je.holder, mesh_engine=je)
    c = tpql.parse(q).calls[0]
    jc = jpql.parse(q).calls[0]
    shards = list(range(N_SHARDS))
    served, overflows = te.topn_slab_served, te.topn_slab_declines["overflow"]
    plan = plans_mod.QueryPlan("i", q)
    with plans_mod.attach(plan):
        got = ex._mesh_topn_shards("i", c, shards, _Opt())
    te.topn_slab_enabled = False
    try:
        oracle = ex._mesh_topn_shards("i", c, shards, _Opt())
    finally:
        te.topn_slab_enabled = True
    want_on = jex._mesh_topn_shards("i", jc, shards, _Opt())
    je.topn_slab_enabled = False
    try:
        want_off = jex._mesh_topn_shards("i", jc, shards, _Opt())
    finally:
        je.topn_slab_enabled = True
    assert got is not None and oracle is not None
    assert got[0] == oracle[0] == set(want_on[0]) == set(want_off[0])
    assert got[1] == oracle[1] == list(want_on[1]) == list(want_off[1])
    assert te.topn_slab_served - served == int(slab)
    assert te.topn_slab_declines["overflow"] - overflows == int(not slab)
    assert ("device_slab" in {op.get("path") for op in plan.ops}) == slab
