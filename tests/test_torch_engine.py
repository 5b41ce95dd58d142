"""TorchEngine (pilosa_tpu_torch.parallel.engine) against the JAX package's
MeshEngine and its host Executor, on one seeded Holder built in both
packages: the Intersect/Union/Difference/Xor trees of __graft_entry__.py,
Not, nested and shard-subset Counts, on a dense field (the dense path)
and a block-clustered field (the sparse path).  Counts are integers:
exact agreement (tolerance 0).  The JAX engine pads the shard axis to its
mesh size and the port pads nothing, so stacks are compared by content
and counts, never by raw shape."""

import numpy as np
import pytest

from pilosa_tpu import pql as jpql
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu_torch import pql as tpql
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.parallel.engine import TorchEngine, UnsupportedLowering

N_SHARDS = 3
SW = bitops.SHARD_WIDTH
CLUSTER_BLOCKS = (3, 9, 40, 41)


def seeded_data(n_shards=N_SHARDS, seed=7):
    """{field: (row_ids, column_ids)}: field d dense (every occupancy block
    of every row holds bits), field c clustered into a few blocks."""
    rng = np.random.default_rng(seed)
    data = {}
    rows, cols = [], []
    for r in (1, 2, 3, 4):
        for s in range(n_shards):
            pos = rng.choice(SW, 20000, replace=False)
            rows.append(np.full(pos.size, r))
            cols.append(s * SW + pos)
    data["d"] = (np.concatenate(rows), np.concatenate(cols))
    rows, cols = [], []
    for r in (1, 2, 3, 4):
        for s in range(n_shards):
            for b in rng.choice(CLUSTER_BLOCKS, 2, replace=False):
                pos = b * bitops.OCC_BLOCK_BITS + rng.choice(bitops.OCC_BLOCK_BITS, 300, replace=False)
                rows.append(np.full(pos.size, r))
                cols.append(s * SW + pos)
    data["c"] = (np.concatenate(rows), np.concatenate(cols))
    return data


def fill(holder, data, index="i"):
    idx = holder.create_index(index)
    every = set()
    for field, (rows, cols) in data.items():
        idx.create_field(field).import_bulk(rows.tolist(), cols.tolist())
        every.update(cols.tolist())
    idx.add_column_existence(sorted(every))
    return holder


def build_twins(n_shards=N_SHARDS, seed=7):
    """The same seeded index in a JAX Holder and a port Holder (CPU)."""
    data = seeded_data(n_shards, seed)
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    return fill(jh, data), fill(th, data)


@pytest.fixture(scope="module")
def twins():
    return build_twins()


@pytest.fixture(scope="module")
def jax_side(twins):
    jh, _ = twins
    return MeshEngine(jh, make_mesh(8)), JExecutor(jh)


TREES = [
    "Intersect(Row({f}=1), Row({f}=2))",
    "Union(Row({f}=1), Row({f}=2))",
    "Difference(Row({f}=1), Row({f}=2))",
    "Xor(Row({f}=1), Row({f}=2))",
    "Union(Row({f}=1), Row({f}=2), Row({f}=3))",
    "Intersect(Union(Row({f}=1), Row({f}=3)), Difference(Row({f}=2), Row({f}=4)))",
    "Not(Row({f}=1))",
    "Intersect(Row({f}=1), Row({f}=99))",
]


@pytest.mark.parametrize("shards", [None, [0, 2]], ids=["all", "subset"])
@pytest.mark.parametrize("field", ["d", "c"])
@pytest.mark.parametrize("tree", TREES)
def test_count_matches_mesh_engine_and_host(twins, jax_side, tree, field, shards):
    jh, th = twins
    jeng, jhost = jax_side
    q = tree.format(f=field)
    want_shards = shards if shards is not None else list(range(N_SHARDS))
    want = jeng.count("i", jpql.parse(q).calls[0], want_shards)
    host = jhost.execute("i", f"Count({q})", shards=shards).results[0]
    assert want == host
    eng = TorchEngine(th, device="cpu")
    got = eng.count("i", tpql.parse(q).calls[0], want_shards)
    assert got == want
    if "99" not in q and not q.startswith("Not"):
        # Dense rows fill every block: dense path.  Clustered rows: sparse.
        assert eng.last_path == ("dense" if field == "d" else "sparse")


def test_paths_agree_with_reference_planner(twins, jax_side):
    """Both planners send the clustered Intersect to the block path and
    the dense one to the full sweep."""
    from pilosa_tpu.parallel.engine import _Lowering as JLowering

    _, th = twins
    jeng, _ = jax_side
    eng = TorchEngine(th, device="cpu")
    shards = list(range(N_SHARDS))
    for field, sparse_expected in (("d", False), ("c", True)):
        q = f"Intersect(Row({field}=1), Row({field}=2))"
        canonical = jeng.canonical_shards("i")
        lw = JLowering(jeng, canonical)
        jprog = jeng._lower("i", jpql.parse(q).calls[0], lw)
        assert (jeng._sparse_plan(jprog, lw, shards, canonical) is not None) == sparse_expected
        eng.count("i", tpql.parse(q).calls[0], shards)
        assert (eng.last_path == "sparse") == sparse_expected


@pytest.mark.parametrize("field", ["d", "c", "exists"])
def test_stack_contents_and_occupancy_match(twins, jax_side, field):
    jh, th = twins
    jeng, _ = jax_side
    jst = jeng.field_stack("i", field, "standard")
    eng = TorchEngine(th, device="cpu")
    st = eng.field_stack("i", field, "standard")
    assert st.shards == jst.shards == list(range(N_SHARDS))
    assert st.row_index == jst.row_index
    jmat = np.asarray(jst.matrix)[:, :N_SHARDS]
    np.testing.assert_array_equal(st.matrix.numpy().view(np.uint32), jmat)
    np.testing.assert_array_equal(st.occ, np.asarray(jst.occ)[:, :N_SHARDS])


def test_sparse_plan_block_lists_exact(twins):
    """The planner lists exactly the blocks both leaves share."""
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    from pilosa_tpu_torch.parallel.engine import _Lowering

    canonical = eng.canonical_shards("i")
    lw = _Lowering(eng, canonical)
    prog = eng._lower("i", tpql.parse("Intersect(Row(c=1), Row(c=2))").calls[0], lw)
    blk_idx, blk_n, skipped = eng._sparse_plan(prog, lw, canonical, canonical)
    st = lw.stacks[0]
    for si in range(len(canonical)):
        both = int(st.occ[prog[1][2], si]) & int(st.occ[prog[2][2], si])
        want = [b for b in range(bitops.OCC_BLOCKS) if both >> b & 1]
        assert blk_idx[si, :blk_n[si]].tolist() == want
    assert blk_idx.shape[1] & (blk_idx.shape[1] - 1) == 0  # power-of-two tier
    assert skipped == 2 * (len(canonical) * 64 - int(blk_n.sum())) * 2048


def test_stack_cached_until_a_write(twins):
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    c = tpql.parse("Intersect(Row(d=1), Row(d=2))").calls[0]
    shards = list(range(N_SHARDS))
    n0 = eng.count("i", c, shards)
    rebuilds = eng.stack_rebuilds
    assert eng.count("i", c, shards) == n0
    assert eng.stack_rebuilds == rebuilds
    f = th.index("i").field("d")
    col = next(x for x in range(SW) if not f.view("standard").fragment(0).bit(1, x)
               and not f.view("standard").fragment(0).bit(2, x))
    f.set_bit(1, col)
    f.set_bit(2, col)
    assert eng.count("i", c, shards) == n0 + 1
    assert eng.stack_rebuilds == rebuilds + 1
    f.clear_bit(1, col)
    f.clear_bit(2, col)
    assert eng.count("i", c, shards) == n0


@pytest.mark.parametrize("q", [
    "Intersect(Row(nope=1), Row(d=2))",
    "Range(d=1, 2010-01-01T00:00, 2011-01-01T00:00)",
    "Not(Row(d=1), Row(d=2))",
])
def test_unsupported_trees_raise_their_own_error(twins, q):
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    with pytest.raises(UnsupportedLowering):
        eng.count("i", tpql.parse(q).calls[0], [0])


def test_tree_past_the_kernel_stack_is_unsupported(twins):
    _, th = twins
    eng = TorchEngine(th, device="cpu")
    q = "Row(d=1)"
    for _ in range(17):
        q = f"Intersect(Row(d=2), {q})"
    with pytest.raises(UnsupportedLowering, match="limits"):
        eng.count("i", tpql.parse(q).calls[0], [0])


def test_default_device_is_the_card():
    """With no device named, the engine and holder ask for the card and
    fail loudly here (no card), never silently using the CPU."""
    import torch

    if torch.cuda.is_available():  # the check below is about a card-less host
        TorchEngine(THolder(device="cpu"))
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        THolder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(THolder(device="cpu"))


def test_core_constructors_default_to_the_card():
    """Objects built outside a Holder ask for the card too: with no device
    named they raise here (no card), and with device="cpu" they are built
    on the CPU."""
    import torch

    from pilosa_tpu_torch.core.field import Field
    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.core.index import Index
    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.core.view import View

    builders = [
        lambda **kw: Fragment("i", "f", "standard", 0, **kw),
        lambda **kw: View("i", "f", "standard", **kw),
        lambda **kw: Field("i", "f", **kw),
        lambda **kw: Index("i", **kw),
        lambda **kw: Row.from_columns([1, SW + 2], **kw),
    ]
    for build in builders:
        obj = build(device="cpu")
        dev = obj.segments[0].device if isinstance(obj, Row) else obj.device
        assert dev == torch.device("cpu")
    if torch.cuda.is_available():  # the check below is about a card-less host
        return
    for build in builders:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
