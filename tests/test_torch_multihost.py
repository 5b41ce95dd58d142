"""The multi-process mesh on the port (``parallel/multihost.py`` on
torch.distributed with gloo, the engine's collectives, K10 ``eval_tree``)
against the JAX package, on the CPU.

- The two-server cases of tests/test_multihost.py run against the port
  (``port_of``): two real ``python`` processes, each a ``Server`` with the
  ``[mesh]`` keys, their collectives crossing the process boundary on
  gloo, one entry node and then both nodes initiating under tickets.  The
  reference's probe of JAX's multi-process support is dropped: gloo needs
  none.
- ``test_two_rank_count_tree_all_reduce``, the port's counterpart of
  ``test_two_process_fused_count`` (whose worker runs JAX): two ranks
  count their blocks of one stack with ``kernels.count_tree`` and sum with
  ``multihost.all_reduce_sum``, held to numpy and to the reference's count.
- ``eval_tree_plain`` and ``TorchEngine.bitmap_stack``/``bitmap_row`` bit
  for bit against the reference's ``MeshEngine.bitmap_stack`` on
  ``make_mesh(8)`` over one seeded holder: row, range and pool leaves, a
  partial shard mask.
- Two port Servers beside two reference Servers on the same data, both
  nodes of each initiating concurrently under tickets: every kind and a
  Row answer the same.

Every process test has its own timeout and kills its processes in
``finally``.  Counts and words are integers: exact agreement (tolerance 0).
"""

import json
import socket
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import test_multihost as jmh
from test_torch_cluster import export, port_of

from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.parallel import MeshEngine, make_mesh
from pilosa_tpu.parallel import mesh as jmesh
from pilosa_tpu.pql import parse as jparse
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.parallel import kernels, mesh as tmesh
from pilosa_tpu_torch.parallel.engine import ResidencyMiss, TorchEngine
from pilosa_tpu_torch.pql import parse as tparse

_DROP_PROBE = (
    (r"from capabilities import require_multiprocess_collectives\s*\n\s*"
     r"require_multiprocess_collectives\(\)", "pass"),
)
_port = port_of("test_multihost", _DROP_PROBE)
# Its worker runs JAX itself: test_two_rank_count_tree_all_reduce below is
# the port's counterpart.
del _port.test_two_process_fused_count
export(_port, globals())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- two ranks, one stack: count_tree + all_reduce_sum -------------------------

RANK_WORKER = r"""
import sys
import numpy as np
import torch

coordinator, pid = sys.argv[1], int(sys.argv[2])
from pilosa_tpu_torch.parallel import kernels, multihost
from pilosa_tpu_torch.parallel.mesh import pad_shards

multihost.initialize(coordinator_address=coordinator, num_processes=2, process_id=pid)
assert multihost.process_count() == 2 and multihost.process_index() == pid

# The host truth, the same in both ranks: 2 rows x 5 shards, rows major;
# the axis pads to 6 and each rank owns 3 positions (rank 1: shards 3, 4
# and one padding position).
S, W = 5, 256
rng = np.random.default_rng(12345)
mat = rng.integers(0, 1 << 32, size=(2, S, W), dtype=np.uint64).astype(np.uint32)
owned = sorted(multihost.owned_positions(pad_shards(S, 2)))
local = np.zeros((2, len(owned), W), dtype=np.uint32)
mask = np.zeros(len(owned), dtype=np.int32)
for i, p in enumerate(owned):
    if p < S:
        local[:, i] = mat[:, p]
        mask[i] = 1
mats = [torch.from_numpy(local.view(np.int32))]
part = kernels.count_tree(("and", ("row", 0, 0), ("row", 0, 1)), mats, torch.from_numpy(mask))
count = int(multihost.all_reduce_sum(part))
per_shard = kernels.eval_tree(("row", 0, 1), mats, torch.from_numpy(mask))
words = multihost.all_gather_shards(per_shard, S).numpy().view(np.uint32)
assert np.array_equal(words, mat[1]), "gathered words"
print(f"OK {pid} {count}", flush=True)
"""


def test_two_rank_count_tree_all_reduce(tmp_path):
    from jax.sharding import PartitionSpec as P

    from pilosa_tpu.parallel.engine import _count_tree
    from pilosa_tpu.parallel.mesh import put_global

    script = tmp_path / "rank_worker.py"
    script.write_text(RANK_WORKER)
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(script), coordinator, str(i)],
                              env=jmh._env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out.split())
    finally:
        for p in procs:
            p.kill()
    rng = np.random.default_rng(12345)
    mat = rng.integers(0, 1 << 32, size=(2, 5, 256), dtype=np.uint64).astype(np.uint32)
    want = int(np.bitwise_count(mat[0] & mat[1]).sum())
    # The reference's fused count over the same stack, on one mesh device:
    # a row leaf names the stack operand and a scalar operand (its row).
    mesh = make_mesh(1)
    ref = int(_count_tree(
        mesh, ("and", ("row", 0, 1), ("row", 0, 2)), (P(None, "shard"), P(), P()),
        put_global(mesh, np.full((5, 1), 0xFFFFFFFF, dtype=np.uint32), P("shard")),
        put_global(mesh, mat, P(None, "shard")), put_global(mesh, np.int32(0), P()),
        put_global(mesh, np.int32(1), P())))
    assert [o[:2] for o in outs] == [["OK", "0"], ["OK", "1"]], outs
    assert {int(o[2]) for o in outs} == {want} and ref == want


def test_pad_shards_and_owner_as_the_reference():
    for world in (1, 2, 3, 4):
        m = make_mesh(world)
        for n in (0, 1, 2, 5, 8, 9):
            assert tmesh.pad_shards(n, world) == jmesh.pad_shards(n, m)
            padded = jmesh.pad_shards(n, m)
            assert [tmesh.shard_owner(p, padded, world) for p in range(padded)] == \
                [jmesh.shard_owner(p, padded, m) for p in range(padded)]
    for bad in (3, 0):
        with pytest.raises(ValueError) as je:
            jmesh.shard_owner(0, bad, make_mesh(2))
        with pytest.raises(ValueError) as te:
            tmesh.shard_owner(0, bad, 2)
        assert str(te.value) == str(je.value)


def test_rank_block_pads_the_last_rank():
    """A rank's block of the canonical axis: positions [r * k, (r + 1) * k)
    of the axis padded to the world size, padding as shard ids that no
    fragment has."""
    h = THolder(device="cpu")
    h.open()
    eng = TorchEngine(h, device="cpu")
    eng.multiproc, eng.world = True, 2
    axis = [0, 3, 4, 7, 9]
    eng.rank = 0
    assert eng._rank_block(axis) == [0, 3, 4]
    eng.rank, again = 1, list(axis)  # a rank's blocks are cached per axis
    assert eng._rank_block(again) == [7, 9, -6]
    assert eng._rank_block([]) == []
    eng.close()


# -- K10's plain version and bitmap_stack against the reference -----------------

N_SHARDS = 6
SW = 1 << 20


def _load(holder, FieldOptions):
    rng = np.random.default_rng(23)
    idx = holder.create_index("i")
    f = idx.create_field("f")
    v = idx.create_field("v", FieldOptions(type="int", min=0, max=1000))
    rows, cols, vcols, vals = [], [], [], []
    for s in range(N_SHARDS):
        for r in range(4):
            c = rng.choice(6000, 700, replace=False)
            rows += [r] * len(c)
            cols += [s * SW + int(x) for x in c]
        vc = rng.choice(6000, 300, replace=False)
        vcols += [s * SW + int(x) for x in vc]
        vals += rng.integers(0, 1000, len(vc)).tolist()
    f.import_bulk(rows, cols)
    v.import_values(vcols, vals)


EVAL_QUERIES = [
    "Row(f=1)",
    "Intersect(Row(f=1), Row(f=2))",
    "Union(Row(f=0), Row(f=3), Row(f=9))",
    "Difference(Row(f=2), Row(f=1))",
    "Xor(Row(f=0), Intersect(Row(f=1), Row(f=3)))",
    "Range(v > 500)",
    "Intersect(Row(f=2), Range(v < 250))",
    "Union(Range(v >= 900), Range(v == 17))",
]
SHARD_SETS = [list(range(N_SHARDS)), [0, 2, 5]]


@pytest.fixture(scope="module")
def engines():
    jh = JHolder()
    jh.open()
    th = THolder(device="cpu")
    th.open()
    _load(jh, JFieldOptions)
    _load(th, TFieldOptions)
    je = MeshEngine(jh, make_mesh(8))
    te = TorchEngine(th, device="cpu")
    yield je, te, th
    je.close()
    te.close()


def _words_of(stack, canonical):
    return np.asarray(stack)[: len(canonical)].view(np.uint32)


@pytest.mark.parametrize("shards", SHARD_SETS, ids=["all", "partial"])
@pytest.mark.parametrize("query", EVAL_QUERIES)
def test_bitmap_stack_as_the_reference(engines, query, shards):
    je, te, _ = engines
    jw, jc = je.bitmap_stack("i", jparse(query).calls[0], shards)
    tw, tc = te.bitmap_stack("i", tparse(query).calls[0], shards)
    assert tc == jc
    assert tw.dtype == torch.int32 and tuple(tw.shape) == (len(tc), kernels.bitops.WORDS)
    assert np.array_equal(tw.numpy().view(np.uint32), _words_of(jw, jc)), query
    jr = je.bitmap_row("i", jparse(query).calls[0], shards)
    tr = te.bitmap_row("i", tparse(query).calls[0], shards)
    assert tr.shards() == jr.shards()
    assert list(tr.columns()) == list(jr.columns())


def test_eval_tree_plain_is_the_masked_tree(engines):
    """K10's plain version, straight over a lowering: the reference's
    masked tree words, and zeros (of the row width) for a zero tree."""
    je, te, _ = engines
    canonical = te.canonical_shards("i")
    from pilosa_tpu_torch.parallel.engine import _Lowering

    lw = _Lowering(te, canonical)
    prog = te._lower("i", tparse("Intersect(Row(f=1), Range(v > 100))").calls[0], lw)
    mask = te._mask_words([1, 4], canonical)
    got = kernels.eval_tree_plain(prog, lw.mats, mask).numpy().view(np.uint32)
    jw, jc = je.bitmap_stack("i", jparse("Intersect(Row(f=1), Range(v > 100))").calls[0],
                             [1, 4])
    assert np.array_equal(got, _words_of(jw, jc))
    zero = kernels.eval_tree(("zero",), [], mask)
    assert tuple(zero.shape) == (len(canonical), kernels.bitops.WORDS) and not zero.any()


def test_bitmap_stack_over_pool_leaves(engines):
    """Under a budget no full stack fits, the first evaluation misses and
    promotes the rows it reads; the next one lowers them to pool leaves
    (``rowb``) and gives the reference's words."""
    je, _, th = engines
    te = TorchEngine(th, device="cpu", max_resident_bytes=3 * N_SHARDS * (32768 * 4 + 16))
    try:
        for query in ("Intersect(Row(f=1), Row(f=2))", "Union(Row(f=0), Row(f=3))"):
            with pytest.raises(ResidencyMiss):
                te.bitmap_stack("i", tparse(query).calls[0], [0, 1, 3])
            assert te.residency.flush(30.0)
            tw, tc = te.bitmap_stack("i", tparse(query).calls[0], [0, 1, 3])
            st = te._stacks[("i", "f", "standard")]
            assert st.partial and st.pool
            jw, jc = je.bitmap_stack("i", jparse(query).calls[0], [0, 1, 3])
            assert np.array_equal(tw.numpy().view(np.uint32), _words_of(jw, jc)), query
    finally:
        te.close()


# -- two port Servers beside two reference Servers, under tickets --------------

DIFF_QUERIES = [
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Row(f=1), Row(f=2)))Count(Xor(Row(f=1), Row(f=2)))",
    "Sum(field=v)",
    "Min(field=v)",
    "Max(Row(f=1), field=v)",
    "TopN(f, n=2)",
    "TopN(f, Row(f=2), n=2)",
    "GroupBy(Rows(field=ga), Rows(field=gb))",
    "Intersect(Row(f=1), Row(f=2))",
    "Union(Row(f=1), Row(f=2))",
]


def test_port_mesh_answers_as_the_reference_mesh(tmp_path):
    pairs = {}
    try:
        for name, mod in (("port", _port), ("ref", jmh)):
            d = tmp_path / name
            d.mkdir()
            script = d / "server_worker.py"
            script.write_text(mod.SERVER_WORKER)
            ports = [_free_port(), _free_port()]
            procs = mod._spawn_servers(d, script, f"127.0.0.1:{_free_port()}", ports,
                                       extra=("seq",))
            pairs[name] = (ports, procs)
        for ports, procs in pairs.values():
            jmh._wait_ready(procs)

        got = {}
        errs = []

        def client(name, port):
            try:
                for q in DIFF_QUERIES:
                    req = urllib.request.Request(f"http://localhost:{port}/index/i/query",
                                                 data=q.encode(), method="POST")
                    doc = json.loads(urllib.request.urlopen(req, timeout=60).read())
                    got[(name, port, q)] = doc["results"]
            except Exception as e:  # noqa: BLE001
                errs.append((name, port, e))

        threads = [threading.Thread(target=client, args=(name, p))
                   for name, (ports, _) in pairs.items() for p in ports]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not [t for t in threads if t.is_alive()], "clients wedged"
        assert not errs, errs
        for q in DIFF_QUERIES:
            answers = [got[(name, p, q)] for name, (ports, _) in pairs.items() for p in ports]
            assert all(a == answers[0] for a in answers), (q, answers)
        # Every port node ran its part of the collectives (the reduce on the
        # mesh), and no broadcast failed over to the host lane.
        for rank, port in enumerate(pairs["port"][0]):
            doc = json.loads(urllib.request.urlopen(
                f"http://localhost:{port}/debug/vars", timeout=30).read())
            mesh = doc["engine"]["mesh"]
            assert mesh["rank"] == rank and mesh["world"] == 2, mesh
            assert mesh["psumDispatches"] >= len(DIFF_QUERIES) and mesh["degraded"] == 0, mesh
    finally:
        for _, procs in pairs.values():
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate(timeout=30)


# -- every engine collective on two ranks, against one process -----------------

ENGINE_WORKER = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
coordinator, pid = sys.argv[1], int(sys.argv[2])
from pilosa_tpu_torch.parallel import multihost
multihost.initialize(coordinator_address=coordinator, num_processes=2, process_id=pid)

from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.parallel.engine import TorchEngine
from pilosa_tpu_torch.pql import parse

# The same holder in both ranks: 5 shards (the axis pads to 6; rank 1
# holds two shards and a padding position), rows of one shard only, a
# BSI field, two group fields.
SW = 1 << 20
rng = np.random.default_rng(5)
h = Holder(device="cpu")
h.open()
idx = h.create_index("i")
f = idx.create_field("f")
rows, cols = [], []
for s in range(5):
    for r in range(6 if s != 4 else 7):
        c = rng.choice(4000, 300 + 40 * r, replace=False)
        rows += [r] * len(c)
        cols += [s * SW + int(x) for x in c]
f.import_bulk(rows, cols)
v = idx.create_field("v", FieldOptions(type="int", min=0, max=500))
vc = [s * SW + int(x) for s in range(5) for x in rng.choice(4000, 200, replace=False)]
v.import_values(vc, rng.integers(0, 500, len(vc)).tolist())
for name, n in (("ga", 3), ("gb", 2)):
    g = idx.create_field(name)
    gc = [s * SW + int(x) for s in range(5) for x in rng.choice(4000, 500, replace=False)]
    g.import_bulk(rng.integers(0, n, len(gc)).tolist(), gc)
for fld in idx.fields.values():
    for vw in fld.views.values():
        for frag in vw.fragments.values():
            frag.cache.recalculate()

mesh = TorchEngine(h, device="cpu")
# Every rank runs this same sequence of calls, so each collective meets
# its peer's without a handoff; the broadcast hook only has to be set.
mesh.collective_broadcast = lambda kind, payload: None
one = TorchEngine(h, device="cpu")
one.multiproc, one.world, one.rank = False, 1, 0
assert mesh.multiproc and mesh.rank == pid
for e in (mesh, one):
    e.MAX_TOPN_CANDIDATES = 4  # f's 7 rows: TopN's union past it declines

def call(text):
    return parse(text).calls[0]

every, some = [0, 1, 2, 3, 4], [1, 4]
for shards in (every, some):
    src = call("Union(Row(f=1), Row(f=6))")
    for e in (mesh, one):
        e.MAX_TOPN_CANDIDATES = 4096
    got = [
        e.count("i", call("Intersect(Row(f=1), Row(f=2))"), shards) for e in (mesh, one)]
    assert got[0] == got[1], got
    got = [e.count_many("i", [call("Row(f=0)"), call("Xor(Row(f=3), Row(f=6))")],
                        [shards, every]) for e in (mesh, one)]
    assert got[0] == got[1], got
    got = [e.sum("i", "v", call("Row(f=2)"), shards) for e in (mesh, one)]
    assert got[0] == got[1], got
    for is_min in (True, False):
        got = [e.min_max("i", "v", None, shards, is_min) for e in (mesh, one)]
        assert got[0] == got[1], got
    got = [e.topn_full("i", "f", src, shards, 3, 1) for e in (mesh, one)]
    assert got[0] == got[1] and got[0], got
    got = [e.topn_full("i", "f", src, shards, 0, 1, row_ids=[6, 2, 5]) for e in (mesh, one)]
    assert got[0] == got[1], got
    got = [e.topn_cache_only("i", "f", shards, 3, 1) for e in (mesh, one)]
    assert got[0] == got[1] and got[0], got
    got = [e.topn_scores("i", "f", [0, 3, 6, 9], src, shards) for e in (mesh, one)]
    assert np.array_equal(got[0][0], got[1][0]) and np.array_equal(got[0][1], got[1][1])
    assert got[0][2] == got[1][2]
    got = [e.group_counts("i", ["ga", "gb"], [[0, 1, 2], [0, 1]], call("Row(f=0)"), shards)
           for e in (mesh, one)]
    assert np.array_equal(got[0], got[1]), got
    got = [e.bitmap_stack("i", call("Difference(Row(f=6), Row(f=1))"), shards)
           for e in (mesh, one)]
    assert got[0][1] == got[1][1] and torch.equal(got[0][0], got[1][0])
    for e in (mesh, one):
        e.MAX_TOPN_CANDIDATES = 4
    assert mesh.topn_full("i", "f", src, shards, 3, 1) is None
    assert mesh.topn_device_full("i", "f", src, shards, 3, 1) is None
red, gat = mesh.mesh_collectives["reduce"][0], mesh.mesh_collectives["gather"][0]
assert red > 0 and gat > 0, mesh.mesh_collectives
print(f"OK {pid} {red} {gat} {mesh.fused_dispatches}", flush=True)
"""


def test_every_collective_on_two_ranks_equals_one_process(tmp_path):
    """Two ranks over one holder, each running the same engine calls (so
    each collective meets its peer's), every answer equal to one process's
    engine over the same holder: Count, a batch, Sum, Min, Max, the full
    TopN (trimmed and by ids), the cache-only TopN, TopN's phase-1 scores,
    GroupBy and a Row's words, over every shard and a subset, on an axis
    of 5 shards that pads to 6; a TopN past MAX_TOPN_CANDIDATES declines."""
    script = tmp_path / "engine_worker.py"
    script.write_text(ENGINE_WORKER)
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(script), coordinator, str(i)],
                              env=jmh._env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=90)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out.split())
    finally:
        for p in procs:
            p.kill()
    assert [o[:2] for o in outs] == [["OK", "0"], ["OK", "1"]], outs
    assert outs[0][2:] == outs[1][2:], outs
