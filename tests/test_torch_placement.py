"""Placement on the port (``pilosa_tpu_torch/cluster/cluster.py``) against
the JAX package: fnv1a64 over the reference's bytes, jump_hash, the
partition of (index, shard), the weighted slot ring and ``shard_nodes``
for random weighted node lists (``devices`` of 1 to 8), equal in both
packages; and every case of tests/test_cluster_internal.py run against
the port (resize sources, owners, topology persistence, the
coordinator)."""

import numpy as np
import pytest

from pilosa_tpu.cluster import cluster as jc
from pilosa_tpu_torch.cluster import cluster as tc
from test_torch_cluster import export, port_of

export(port_of("test_cluster_internal"), globals())


def test_fnv_and_jump_hash_equal():
    rng = np.random.default_rng(1)
    for _ in range(300):
        data = rng.bytes(int(rng.integers(0, 40)))
        assert tc.fnv1a64(data) == jc.fnv1a64(data)
        key = int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2))
        n = int(rng.integers(1, 300))
        assert tc.jump_hash(key, n) == jc.jump_hash(key, n)


def _nodes(mod, spec):
    return [mod.Node(nid, f"http://{nid}", i == 0, devices=d) for i, (nid, d) in enumerate(spec)]


@pytest.mark.parametrize("seed", range(8))
def test_weighted_placement_equal(seed):
    """``shard_nodes`` and ``place_partition`` for random node lists of
    random weights, at replicas 1 to 3, in both packages."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    spec = [(f"node-{rng.integers(0, 1000):03d}-{k}", int(rng.integers(1, 9))) for k in range(n)]
    for replicas in (1, 2, 3):
        jcl = jc.Cluster(_nodes(jc, spec)[0], replica_n=replicas)
        tcl = tc.Cluster(_nodes(tc, spec)[0], replica_n=replicas)
        jcl.nodes = sorted(_nodes(jc, spec), key=lambda x: x.id)
        tcl.nodes = sorted(_nodes(tc, spec), key=lambda x: x.id)
        for index in ("i", "bench", "x" * 20):
            for shard in list(range(64)) + [int(s) for s in rng.integers(0, 1 << 40, 16)]:
                assert tcl.partition(index, shard) == jcl.partition(index, shard)
                assert [x.id for x in tcl.shard_nodes(index, shard)] == \
                    [x.id for x in jcl.shard_nodes(index, shard)]
        for p in range(0, 256, 7):
            assert [x.id for x in tc.place_partition(tcl.nodes, replicas, p)] == \
                [x.id for x in jc.place_partition(jcl.nodes, replicas, p)]


def test_slot_ring_wraps_as_the_reference():
    spec = [("a", 3), ("b", 1), ("c", 2)]
    jr = jc.build_slot_ring(_nodes(jc, spec))
    tr = tc.build_slot_ring(_nodes(tc, spec))
    assert [x.id for x in tr[0]] == [x.id for x in jr[0]] and tr[1] == jr[1]
    for partition in range(256):
        for replicas in (1, 2, 3, 4):
            assert [x.id for x in tc.place_on_ring(tr[0], tr[1], replicas, partition)] == \
                [x.id for x in jc.place_on_ring(jr[0], jr[1], replicas, partition)]
