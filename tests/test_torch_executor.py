"""Executor.execute of the port (pilosa_tpu_torch.executor) on PQL text,
end to end, against the JAX package's executor — fused through its
MeshEngine and on its host path — on one seeded index built in both
packages (test_torch_engine.build_twins).  Counts and row columns are
integers: exact agreement (tolerance 0)."""

import numpy as np
import pytest

from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.executor import Executor, FieldNotFoundError
from pilosa_tpu_torch.parallel import kernels
from pilosa_tpu_torch.parallel.engine import TorchEngine
from test_torch_engine import N_SHARDS, SW, build_twins


def executors(jh, th):
    return (
        JExecutor(jh, mesh_engine=MeshEngine(jh, make_mesh(8))),
        JExecutor(jh),
        Executor(th, engine=TorchEngine(th, device="cpu")),
    )


@pytest.fixture(scope="module")
def trio():
    return executors(*build_twins())


def results(ex, q, shards=None):
    return ex.execute("i", q, shards=shards).results


QUERIES = [
    "Count(Intersect(Row(d=1), Row(d=2)))",
    "Count(Union(Row(c=1), Row(c=2)))",
    "Count(Difference(Row(d=3), Row(d=4)))",
    "Count(Xor(Row(c=2), Row(c=3)))",
    "Count(Not(Row(c=1)))",
    "Count(Not(Intersect(Row(d=1), Row(d=2))))",
    "Count(Intersect(Row(d=1), Row(c=1)))",
    "Count(Row(d=2))",
    "Count(Union())",
    "Count(Intersect(Row(d=1), Row(d=2))) Count(Union(Row(c=1), Row(c=4)))",
]


@pytest.mark.parametrize("q", QUERIES)
def test_counts_match_fused_and_host(trio, q):
    fused, host, port = trio
    want = results(fused, q)
    assert want == results(host, q)
    assert results(port, q) == want


@pytest.mark.parametrize("q", [
    "Intersect(Row(d=1), Row(d=2))",
    "Union(Row(c=1), Row(c=3))",
    "Difference(Row(c=1), Row(c=2))",
    "Xor(Row(d=1), Row(c=1))",
    "Not(Row(c=2))",
    "Row(c=4)",
])
def test_bitmap_rows_match_host(trio, q):
    _, host, port = trio
    want = results(host, q)[0].columns()
    got = results(port, q)[0].columns()
    np.testing.assert_array_equal(got, want)


def test_shard_subset(trio):
    fused, _, port = trio
    q = "Count(Union(Row(c=1), Row(d=2)))"
    assert results(port, q, shards=[1]) == results(fused, q, shards=[1])


def test_set_then_count_intersect():
    jh, th = build_twins()
    fused, host, port = executors(jh, th)
    q = "Count(Intersect(Row(c=1), Row(c=2)))"
    base = results(port, q)[0]
    assert base == results(fused, q)[0]
    # A column neither row holds: the count moves by exactly one.
    col = 2 * SW + 5
    for ex in (fused, port):
        assert results(ex, f"Set({col}, c=1) Set({col}, c=2)") == [True, True]
    assert results(port, q)[0] == base + 1 == results(fused, q)[0] == results(host, q)[0]
    assert results(port, f"Set({col}, c=1)") == [False]
    for ex in (fused, port):
        assert results(ex, f"Clear({col}, c=2)") == [True]
    assert results(port, q)[0] == base == results(fused, q)[0]
    # Set writes the existence bit too, which Not() reads.
    q_not = "Count(Not(Row(c=1)))"
    for ex in (fused, port):
        results(ex, f"Set({3 * SW - 1}, d=7)")
    assert results(port, q_not) == results(fused, q_not) == results(host, q_not)


def test_write_rebuilds_the_stack_and_kernel_path_counts():
    jh, th = build_twins()
    _, _, port = executors(jh, th)
    eng = port.engine
    q = "Count(Intersect(Row(d=1), Row(d=2)))"
    results(port, q)
    rebuilds = eng.stack_rebuilds
    dense = eng.dense_dispatches
    results(port, q)
    assert (eng.stack_rebuilds, eng.dense_dispatches) == (rebuilds, dense + 1)
    results(port, "Set(17, d=1)")
    results(port, q)
    assert eng.stack_rebuilds == rebuilds + 1
    # A bare Count(Row) never reaches the engine (the O(1) lane).
    results(port, "Count(Row(d=1))")
    assert eng.dense_dispatches == dense + 2 and eng.sparse_dispatches == 0
    # On the CPU no CUDA kernel launches: the wrappers take the plain path.
    assert kernels.count_tree_dense.launches == 0


def test_field_types_round_trip():
    jh, th = build_twins()
    fused, host, port = executors(jh, th)
    from pilosa_tpu.core.field import FieldOptions as JFieldOptions

    jh.index("i").create_field("m", JFieldOptions(type="mutex"))
    th.index("i").create_field("m", TFieldOptions(type="mutex"))
    jh.index("i").create_field("v", JFieldOptions(type="int", min=-5, max=100))
    th.index("i").create_field("v", TFieldOptions(type="int", min=-5, max=100))
    for q in ("Set(10, m=1)", "Set(10, m=2)", "Set(11, m=1)", "Set(10, v=42)", "Set(12, v=-5)"):
        assert results(port, q) == results(fused, q)
    for q in ("Count(Union(Row(m=1), Row(m=2)))", "Count(Row(m=1))", "Count(Row(m=2))"):
        assert results(port, q) == results(fused, q) == results(host, q)
    assert th.index("i").field("v").value(10) == jh.index("i").field("v").value(10) == (42, True)
    assert th.index("i").field("v").value(12) == (-5, True)


def test_deep_tree_serves_from_the_host_lane(trio):
    fused, _, port = trio
    q = "Row(d=1)"
    for k in range(17):
        q = f"Union(Row(c={1 + k % 4}), {q})"
    q = f"Count({q})"
    assert results(port, q) == results(fused, q)


def test_errors(trio):
    _, host, port = trio
    with pytest.raises(FieldNotFoundError):
        results(port, "Count(Intersect(Row(nope=1), Row(d=1)))")
    # TopN is ported (Queue 1 item 10); GroupBy and Rows are not yet.
    assert results(port, "TopN(d, n=2)") == results(host, "TopN(d, n=2)")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11"):
        results(port, "Rows(field=d)")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 9"):
        results(port, "Count(Range(d=1, 2010-01-01T00:00, 2011-01-01T00:00))")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        results(port, "Sum(field=d)")
    with pytest.raises(Exception, match="single input row"):
        results(port, "Count(Not(Row(d=1), Row(d=2)))")
    assert N_SHARDS == len(port.engine.canonical_shards("i"))
