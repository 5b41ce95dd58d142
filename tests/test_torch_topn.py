"""TopN in the port (pilosa_tpu_torch) against the JAX package, on one seeded
index built in both packages over 8 shards (the JAX side on its 8-device
CPU mesh).

- Every query's pair list through ``Executor.execute`` equals both the JAX
  ``Executor`` with ``MeshEngine`` and the JAX host ``Executor(holder)``:
  n in {0, 1, 3, all}, threshold, ids= (absent ids too), no src, Tanimoto,
  multi-leaf src trees, shard subsets, duplicate counts that pin the
  (-count, -id) tie-break, a field of 600 rows (1024 candidate slots) whose
  rows come in threes with equal bits, and a candidate union past
  MAX_TOPN_CANDIDATES (the two-phase path).
- ``topn_trim_plain`` (the plain version of K3's trim) equals
  ``jax.lax.top_k`` at K up to 4096 for tied, zero, distinct and
  int32-max totals.
- The kernels' plain versions equal the JAX programs on the same words:
  ``score_rows``, ``topn_tree``, ``topn_full_tree`` (and
  ``fusion.decode_topn_full_scores``), ``Fragment.top``, and P2 — the Pallas
  kernel ``scripts/pallas_vs_xla.py:56`` run in interpret mode — against
  ``bitops.popcount_and_rows``.

Counts are integers: exact agreement (tolerance 0).  The CUDA kernels run
only on the card (chip_smoke.py holds them against these plain versions
there); here the wrappers take the plain versions because the tensors lie
on the CPU."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.parallel import fusion as jfusion
from pilosa_tpu.parallel import kernels as jk
from pilosa_tpu.parallel.mesh import SHARD_AXIS, put_global
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.parallel import kernels
from pilosa_tpu_torch.parallel.engine import TorchEngine, decode_topn_full

N_SHARDS = 8
SW = bitops.SHARD_WIDTH
W = bitops.WORDS
SPAN = 4096  # columns of each shard the rows draw from
DUP_ROWS = (30, 31, 32)  # identical bits: every count and score ties
WIDE_BASE = 200  # field m: rows b, b + 200 and b + 400 share base row b's bits
M_SHARDS = (0, 1, 4)  # field m's shards (the host lane counts 600 rows in each)


def topn_data(seed=11):
    """{field: (rows, cols)}.  Field t: rows 1..20 whose density grows with
    the row id (so per-shard and global orders agree, as the two-phase
    reference needs to be exact), plus three identical rows of middling
    density.  Field w: src rows of three densities (5 dense, 6 medium, 7
    sparse).  Field m: 600 rows in threes of equal bits, over 200
    base rows of 3 to 152 columns, on M_SHARDS only; field ms row 1: their union."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for s in range(N_SHARDS):
        base = s * SW
        for r in range(1, 21):
            pos = rng.choice(SPAN, 10 + 12 * r + int(rng.integers(0, 6)), replace=False)
            rows.append(np.full(pos.size, r))
            cols.append(base + pos)
        dup = rng.choice(SPAN, 150, replace=False)
        for r in DUP_ROWS:
            rows.append(np.full(dup.size, r))
            cols.append(base + dup)
    data = {"t": (np.concatenate(rows), np.concatenate(cols))}
    rows, cols = [], []
    for s in range(N_SHARDS):
        for r, size in ((5, 2400), (6, 800), (7, 40)):
            pos = rng.choice(SPAN, size, replace=False)
            rows.append(np.full(pos.size, r))
            cols.append(s * SW + pos)
    data["w"] = (np.concatenate(rows), np.concatenate(cols))
    rows, cols, src = [], [], []
    for s in M_SHARDS:
        union = set()
        for b in range(WIDE_BASE):
            pos = rng.choice(SPAN, 3 + b % 150, replace=False)
            union.update(pos.tolist())
            for r in (b, b + WIDE_BASE, b + 2 * WIDE_BASE):
                rows.append(np.full(pos.size, r))
                cols.append(s * SW + pos)
        src.append(s * SW + np.asarray(sorted(union)))
    data["m"] = (np.concatenate(rows), np.concatenate(cols))
    src = np.concatenate(src)
    data["ms"] = (np.ones(src.size, np.int64), src)
    return data


def fill(holder, data, index="i"):
    idx = holder.create_index(index)
    every = set()
    for field, (rows, cols) in data.items():
        idx.create_field(field).import_bulk(rows.tolist(), cols.tolist())
        every.update(cols.tolist())
    idx.add_column_existence(sorted(every))
    return holder


def build_twins():
    data = topn_data()
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    return fill(jh, data), fill(th, data)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch ops: under several test
    workers on a few cores a thread pool per worker spends its time
    contending (the 600-row field's counts above all), not counting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    return build_twins()


@pytest.fixture(scope="module")
def executors(twins):
    jh, th = twins
    return (
        JExecutor(jh, mesh_engine=MeshEngine(jh, make_mesh(8))),
        JExecutor(jh),
        Executor(th, engine=TorchEngine(th, device="cpu")),
        Executor(th),
    )


def pairs(ex, q, shards=None):
    return [tuple(p) for p in ex.execute("i", q, shards=shards).results[0]]


QUERIES = [
    "TopN(t, Row(w=5))",
    "TopN(t, Row(w=5), n=0)",
    "TopN(t, Row(w=5), n=1)",
    "TopN(t, Row(w=5), n=3)",
    "TopN(t, Row(w=5), n=100)",
    "TopN(t, Row(w=6), n=3)",
    "TopN(t, Row(w=7), n=4)",
    "TopN(t, Row(w=5), n=4, threshold=40)",
    "TopN(t, Row(w=6), n=5, threshold=1000)",
    "TopN(t, Row(w=5), ids=[1, 3, 30, 31, 99])",
    "TopN(t, Row(w=6), n=2, ids=[30, 31, 32])",
    "TopN(t, n=3)",
    "TopN(t)",
    "TopN(t, n=2, threshold=150)",
    "TopN(t, ids=[2, 5, 77])",
    "TopN(t, Intersect(Row(w=5), Row(w=6)), n=4)",
    "TopN(t, Union(Row(w=6), Difference(Row(w=5), Row(w=7))), n=4)",
    "TopN(t, Not(Row(w=6)), n=3)",
    "TopN(t, Union(Row(t=19), Row(t=20)), n=3, tanimotoThreshold=20)",
    "TopN(t, Row(w=5), n=3, tanimotoThreshold=5)",
    "TopN(t, Row(w=99), n=3)",
    "TopN(t, Row(w=5), n=2)",
    "TopN(t, Row(t=31), n=2)",
    "TopN(t, Intersect(Row(t=30), Row(w=5)), n=4)",
    "TopN(m, Row(ms=1), n=5)",
    "TopN(m, Row(ms=1), n=0)",
    "TopN(m, Row(ms=1), n=600)",
]


@pytest.mark.parametrize("shards", [None, [1, 4, 6]], ids=["all", "subset"])
@pytest.mark.parametrize("q", QUERIES)
def test_topn_matches_both_jax_executors(executors, q, shards):
    fused, host, port, port_host = executors
    want = pairs(fused, q, shards)
    assert pairs(host, q, shards) == want
    assert pairs(port, q, shards) == want
    assert pairs(port_host, q, shards) == want


def test_dup_rows_pin_the_tie_break(executors):
    """The three identical rows tie on every count and score, and against
    their own pattern they outscore every other row; the higher id wins,
    so n=2 keeps 32 and 31."""
    _, _, port, _ = executors
    for q in ("TopN(t, Row(t=31), n=2)", "TopN(t, Intersect(Row(t=30), Row(w=5)), n=2)"):
        got = pairs(port, q)
        assert [r for r, _ in got] == [32, 31] and got[0][1] == got[1][1], q


TWO_PHASE = [
    "TopN(t, Row(w=5), n=3)",
    "TopN(t, Row(w=6), n=2, threshold=10)",
    "TopN(t, Intersect(Row(w=5), Row(w=6)), n=4)",
    "TopN(t, n=3)",
]


@pytest.mark.parametrize("shards", [None, [0, 3, 5, 7]], ids=["all", "subset"])
@pytest.mark.parametrize("q", TWO_PHASE)
def test_union_past_max_candidates_takes_two_phases(twins, q, shards):
    """A candidate union past MAX_TOPN_CANDIDATES makes the fused TopN
    decline on both engines; the two-phase path (phase-1 scores of every
    shard in one launch, the host heap walk, the phase-2 recount) answers
    as the JAX executors do."""
    jh, th = twins
    jeng = MeshEngine(jh, make_mesh(8))
    teng = TorchEngine(th, device="cpu")
    jeng.MAX_TOPN_CANDIDATES = teng.MAX_TOPN_CANDIDATES = 4
    want = pairs(JExecutor(jh, mesh_engine=jeng), q, shards)
    assert pairs(JExecutor(jh), q, shards) == want
    assert pairs(Executor(th, engine=teng), q, shards) == want


def test_fused_lane_declines_past_max(twins):
    _, th = twins
    teng = TorchEngine(th, device="cpu")
    src = Executor(th)._parse_cached("Row(w=5)").calls[0]
    assert teng.topn_full("i", "t", src, list(range(N_SHARDS)), 3, 1) is not None
    teng.MAX_TOPN_CANDIDATES = 4
    assert teng.topn_full("i", "t", src, list(range(N_SHARDS)), 3, 1) is None
    assert teng.topn_cache_only("i", "t", list(range(N_SHARDS)), 3, 1) is None


def test_attribute_filter_is_not_ported(twins, executors):
    """The attribute filter, once a pinned raise, now answers as the JAX
    executors' two-phase lane does: the fused TopN declines it, K3 scores
    the candidates and ``Fragment.top`` filters them by row attribute."""
    jh, th = twins
    for h in (jh, th):
        h.index("i").field("t").row_attr_store.set_bulk_attrs(
            {r: {"cat": "ab"[r % 2]} for r in range(1, 21)})
    fused, host, port, port_host = executors
    q = 'TopN(t, Row(w=5), n=3, attrName="cat", attrValues=["a"])'
    want = pairs(fused, q)
    assert want and all(r % 2 == 0 for r, _ in want)
    assert pairs(host, q) == want
    assert pairs(port, q) == want
    assert pairs(port_host, q) == want


def test_tanimoto_past_100_is_an_error(executors):
    from pilosa_tpu_torch.executor import Error

    _, _, port, _ = executors
    with pytest.raises(Error, match="Tanimoto"):
        port.execute("i", "TopN(t, Row(w=5), n=3, tanimotoThreshold=101)")


# -- the kernels' plain versions against the JAX programs -------------------


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def words(rng, shape):
    """Random words with the all-ones and sign-bit-only words mixed in."""
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    pick = rng.choice(flat.size, 64, replace=False)
    flat[pick[:32]] = 0xFFFFFFFF
    flat[pick[32:]] = 0x80000000
    return w


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("K", [1, 3, 130])
def test_score_rows_plain_matches_reference(K):
    rng = np.random.default_rng(K)
    cands, src = words(rng, (K, 2, W)), words(rng, (2, W))
    want = np.asarray(jk.score_rows(jnp.asarray(cands), jnp.asarray(src)))
    got = kernels.score_rows(t32(cands), t32(src))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


SRC_PROGS = {
    "row": ("row", 0, 1),
    "and": ("and", ("row", 0, 0), ("row", 1, 2)),
    "nested": ("andnot", ("or", ("row", 0, 0), ("row", 1, 1)), ("row", 0, 2)),
    "zero": ("zero",),
}
MASKS = {"all": np.ones(N_SHARDS, np.int32),
         "some": np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int32)}


@pytest.fixture(scope="module")
def stacks():
    """Two src stacks uint32[3, S, W] and a candidate stack uint32[6, S, W]
    (row 5 empty, row 4 a copy of row 3: tied scores)."""
    rng = np.random.default_rng(5)
    src = [words(rng, (3, N_SHARDS, W)) for _ in range(2)]
    cand = words(rng, (6, N_SHARDS, W)) & words(rng, (6, N_SHARDS, W))
    cand[5] = 0
    cand[4] = cand[3]
    return src, cand


def jax_operands(mesh, prog, mats):
    """The JAX form of a src tree: stack operands, scalar row operands and
    a zero stack for zero leaves (as tests/test_torch_kernels.py builds)."""
    operands = [put_global(mesh, m, P(None, SHARD_AXIS)) for m in mats]
    specs = [P(None, SHARD_AXIS)] * len(mats)
    operands.append(put_global(mesh, np.zeros((1, N_SHARDS, W), np.uint32), P(None, SHARD_AXIS)))
    specs.append(P(None, SHARD_AXIS))
    zero_i = len(operands) - 1

    def conv(p):
        if p[0] == "row":
            operands.append(put_global(mesh, np.int32(p[2]), P()))
            specs.append(P())
            return ("row", p[1], len(operands) - 1)
        if p[0] == "zero":
            return ("zero", zero_i)
        return (p[0],) + tuple(conv(q) for q in p[1:])

    return conv(prog), operands, specs


def jax_mask(mesh, mask):
    host = np.where(mask[:, None] != 0, 0xFFFFFFFF, 0).astype(np.uint32)
    return put_global(mesh, host, P(SHARD_AXIS))


CAND_IDX = np.array([3, 0, 4, 5, 2, 0, 0, 0], np.int32)  # ties, empty row, pads


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("prog_name", sorted(SRC_PROGS))
def test_topn_tree_plain_matches_reference(mesh, stacks, prog_name, mask_name):
    src, cand = stacks
    prog, mask = SRC_PROGS[prog_name], MASKS[mask_name]
    jprog, ops, specs = jax_operands(mesh, prog, src)
    jscores, jcounts = jk.topn_tree(
        mesh, jprog, tuple(specs), jax_mask(mesh, mask),
        put_global(mesh, cand, P(None, SHARD_AXIS)),
        put_global(mesh, CAND_IDX, P()), *ops,
    )
    scores, counts = kernels.topn_tree(
        prog, [t32(m) for m in src], torch.from_numpy(mask), t32(cand),
        torch.from_numpy(CAND_IDX),
    )
    assert scores.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("n_out", [None, 1, 3, 8])
@pytest.mark.parametrize("thr", [1, 900000, 1 << 30])
@pytest.mark.parametrize("prog_name", ["row", "nested"])
def test_topn_full_tree_plain_matches_reference(mesh, stacks, prog_name, thr, n_out):
    src, cand = stacks
    prog, mask = SRC_PROGS[prog_name], MASKS["some"]
    cands = [50, 40, 31, 30, 20]  # id-descending; slots 5..7 are pads
    rng = np.random.default_rng(thr % 97)
    host_cnt = np.zeros((N_SHARDS, 8), np.int32)
    host_cnt[:, :5] = rng.integers(0, 2 << 20, (N_SHARDS, 5))
    host_cnt[2, 1] = 0  # an absent row on one shard
    jprog, ops, specs = jax_operands(mesh, prog, src)
    jout = jk.topn_full_tree(
        mesh, jprog, (P(),) + tuple(specs), n_out, None, jax_mask(mesh, mask),
        put_global(mesh, cand, P(None, SHARD_AXIS)),
        put_global(mesh, host_cnt.T.copy(), P(None, SHARD_AXIS)),
        put_global(mesh, np.int32(thr), P()),
        put_global(mesh, CAND_IDX, P()), *ops,
    )
    out = kernels.topn_full_tree(
        prog, [t32(m) for m in src], torch.from_numpy(mask), t32(cand),
        torch.from_numpy(CAND_IDX), torch.from_numpy(host_cnt.T.copy()), thr, n_out,
    )
    if n_out is None:
        assert out.dtype == torch.int64
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        host = out.numpy()
    else:
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
        host = (out[0].numpy(), out[1].numpy())
    # The host replica of the gates and trim over the phase-1 scores.
    scores, counts = kernels.topn_tree(
        prog, [t32(m) for m in src], torch.from_numpy(mask), t32(cand),
        torch.from_numpy(CAND_IDX),
    )
    want = jfusion.decode_topn_full_scores(
        (scores.numpy(), counts.numpy()), host_cnt, cands, thr, n_out
    )
    assert decode_topn_full(host, cands, n_out) == want


@pytest.mark.parametrize("n_out", [None, 16])
@pytest.mark.parametrize("thr", [1, 1 << 30], ids=["gated", "all_zero"])
def test_topn_full_tree_one_output(mesh, stacks, thr, n_out):
    """The fused TopN's one output, at the main path's K = 16 (candidate
    slots in pairs that tie): int32[2, n_out] (values, then candidate
    indices) with n_out = K, or the int64[K] totals with n_out None,
    equal to the JAX program and to decode_topn_full_scores.  thr past
    every count gates every pair out: all-zero totals."""
    src, cand = stacks
    prog, mask = SRC_PROGS["and"], MASKS["some"]
    cand_idx = np.repeat(np.array([3, 4, 0, 2, 1, 5, 0, 0], np.int32), 2)
    cands = list(range(60, 48, -1))  # 12 id-descending candidates, 4 pads
    host_cnt = np.zeros((N_SHARDS, 16), np.int32)
    host_cnt[:, :12] = np.repeat(np.random.default_rng(8).integers(1, 2 << 20, (N_SHARDS, 6)),
                                 2, axis=1)
    jprog, ops, specs = jax_operands(mesh, prog, src)
    jout = jk.topn_full_tree(
        mesh, jprog, (P(),) + tuple(specs), n_out, None, jax_mask(mesh, mask),
        put_global(mesh, cand, P(None, SHARD_AXIS)),
        put_global(mesh, host_cnt.T.copy(), P(None, SHARD_AXIS)),
        put_global(mesh, np.int32(thr), P()),
        put_global(mesh, cand_idx, P()), *ops,
    )
    out = kernels.topn_full_tree(
        prog, [t32(m) for m in src], torch.from_numpy(mask), t32(cand),
        torch.from_numpy(cand_idx), torch.from_numpy(host_cnt.T.copy()), thr, n_out,
    )
    if n_out is None:
        assert out.dtype == torch.int64 and out.shape == (16,)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        host = out.numpy()
    else:
        assert out.dtype == torch.int32 and out.shape == (2, n_out)
        np.testing.assert_array_equal(out.numpy(), np.stack([np.asarray(j) for j in jout]))
        host = (out[0].numpy(), out[1].numpy())
    scores, counts = kernels.topn_tree(
        prog, [t32(m) for m in src], torch.from_numpy(mask), t32(cand),
        torch.from_numpy(cand_idx),
    )
    want = jfusion.decode_topn_full_scores(
        (scores.numpy(), counts.numpy()), host_cnt, cands, thr, n_out
    )
    assert decode_topn_full(host, cands, n_out) == want
    if thr > 1:
        assert want == []


@pytest.mark.parametrize("case", ["ties", "zeros", "distinct"])
def test_topn_trim_plain_order(case):
    """Value descending, the lower index first on ties — jax.lax.top_k's
    order — for every n_out."""
    import jax

    rng = np.random.default_rng(3)
    totals = {"ties": rng.integers(0, 3, 64), "zeros": np.zeros(16, np.int64),
              "distinct": rng.permutation(32)}[case].astype(np.int64)
    for n_out in (1, 5, totals.size):
        vals, idx = kernels.topn_trim_plain(torch.from_numpy(totals), n_out)
        jv, ji = jax.lax.top_k(jnp.asarray(totals.astype(np.int32)), n_out)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def _trim_totals(case, K, rng):
    if case == "levels3":  # three values: ties everywhere
        return rng.choice(np.array([0, 7, 1 << 20]), K)
    if case == "zeros":
        return np.zeros(K, np.int64)
    if case == "distinct":
        return rng.permutation(K).astype(np.int64) * 3
    # Half at 2^31 - 1, the largest total an int32 holds, the rest below it.
    return np.where(rng.random(K) < 0.5, 2 ** 31 - 1, rng.integers(0, 2 ** 31 - 1, K))


@pytest.mark.parametrize("case", ["levels3", "zeros", "distinct", "int32_max"])
@pytest.mark.parametrize("K", [1, 16, 257, 1000, 4096])
def test_topn_trim_plain_matches_top_k(K, case):
    """The plain trim against jax.lax.top_k over the same int32 totals,
    exactly, at K from 1 to the 4096 candidates a fused TopN takes and
    n_out on both sides of 256 (and of K3's sort widths: 16 keys a
    thread, 512 a warp)."""
    import jax

    rng = np.random.default_rng(K)
    totals = _trim_totals(case, K, rng).astype(np.int64)
    for n_out in sorted({n for n in (1, 5, 255, 256, 257, 511, 512, 513) if n <= K} | {K}):
        vals, idx = kernels.topn_trim_plain(torch.from_numpy(totals), n_out)
        jv, ji = jax.lax.top_k(jnp.asarray(totals.astype(np.int32)), n_out)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv), err_msg=f"n_out={n_out}")
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji), err_msg=f"n_out={n_out}")


@pytest.mark.parametrize("kw", [
    {"n": 3},
    {"n": 0},
    {"n": 5, "min_threshold": 30},
    {"row_ids": [1, 7, 30, 31, 99]},
    {"n": 3, "tanimoto_threshold": 5},
])
def test_fragment_top_matches_reference(twins, kw):
    jh, th = twins
    for shard in (0, 5):
        jf = jh.fragment("i", "t", "standard", shard)
        tf = th.fragment("i", "t", "standard", shard)
        jsrc = jh.fragment("i", "w", "standard", shard).row(5)
        tsrc = th.fragment("i", "w", "standard", shard).row(5)
        assert tf.top(src=tsrc, **kw) == jf.top(src=jsrc, **kw)
        assert tf.top(**kw) == jf.top(**kw)
        rows = tf.row_ids()
        np.testing.assert_array_equal(tf.counts_for(rows + [999]),
                                      jf.counts_for(rows + [999]))


def _pallas_script():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "pallas_vs_xla", os.path.join(root, "scripts", "pallas_vs_xla.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["random", "all_ones", "sign_bit", "by_index"])
def test_p2_matches_the_pallas_kernel(case):
    """P2, the Pallas kernel scripts/pallas_vs_xla.py:56 in interpret mode,
    against the port's popcount_and_rows (plain here, P2
    csrc/and_popcount_rows.cu on the card).  by_index: the port names 16
    rows of a 24-row matrix out of order and reads them in place; the
    Pallas kernel scores the same rows gathered."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(17)
    mat, row = words(rng, (16, W)), words(rng, W)
    rows = None
    if case == "all_ones":
        mat[::2] = 0xFFFFFFFF
        row[:] = 0xFFFFFFFF
    elif case == "sign_bit":
        mat[1::2] = 0x80000000
        row[::3] = 0x80000000
    elif case == "by_index":
        full = words(rng, (24, W))
        rows = rng.permutation(24)[:16].tolist()
        mat = full[rows]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_script().matrix_and_popcount_pallas(
            jnp.asarray(mat), jnp.asarray(row), 8))
    if rows is None:
        got = bitops.popcount_and_rows(t32(mat), t32(row))
    else:
        got = bitops.popcount_and_rows(t32(full), t32(row), rows=rows)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_wrappers_refuse_cpu_tensors(stacks):
    src, cand = stacks
    code = kernels.compile_prog(SRC_PROGS["row"])
    mask = torch.ones(N_SHARDS, dtype=torch.int32)
    with pytest.raises(ValueError, match="card"):
        kernels.score_rows_cuda(code, [t32(m) for m in src], mask, t32(cand), None)
    with pytest.raises(ValueError, match="card"):
        kernels.score_rows_cuda(code, [t32(m) for m in src], mask, t32(cand),
                                torch.from_numpy(CAND_IDX), scores=False,
                                cnt=torch.ones((8, N_SHARDS), dtype=torch.int32), n_out=2)
    with pytest.raises(ValueError, match="card"):
        kernels.and_popcount_rows_cuda(t32(cand[0]), t32(cand[0, 0]))
    with pytest.raises(ValueError, match="card"):
        kernels.and_popcount_rows_cuda(t32(cand[0]), t32(cand[0, 0]), rows=[1, 0])
    assert kernels.score_rows_cuda.launches == 0
    assert not kernels._totals_scratch  # a refused launch allocates no scratch
    assert kernels.and_popcount_rows_cuda.launches == 0


def test_src_tree_past_the_limits_takes_the_host_lane(twins):
    """A src tree deeper than the kernels' stack is UnsupportedLowering in
    the engine; the executor answers it from the host lane, as the JAX
    executors answer it."""
    jh, th = twins
    q = "Row(w=5)"
    for _ in range(17):
        q = f"Intersect(Row(w=5), {q})"
    q = f"TopN(t, {q}, n=3)"
    want = pairs(JExecutor(jh), q)
    assert pairs(Executor(th, engine=TorchEngine(th, device="cpu")), q) == want
