"""The port's word layer (pilosa_tpu_torch.ops.bitops) against the JAX
package's (pilosa_tpu.ops.bitops) on the same seeded words.  Integer
results, so every comparison is exact (tolerance 0)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitops as ref
from pilosa_tpu_torch.ops import bitops as port

SPECIAL = np.array([0xFFFFFFFF, 0x80000000, 0, 1, 0x7FFFFFFF], dtype=np.uint32)


def words(rng, shape):
    """Random uint32 words with the sign-bit and all-ones words mixed in."""
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    idx = rng.choice(flat.size, size=min(flat.size, 64), replace=False)
    flat[idx] = SPECIAL[np.arange(idx.size) % SPECIAL.size]
    return w


def t(w):
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32))


def back(x):
    return x.numpy().view(np.uint32)


def test_geometry_matches():
    for name in ("SHARD_WIDTH_EXP", "SHARD_WIDTH", "WORDS", "WORDS64",
                 "OCC_BLOCK_WORDS", "OCC_BLOCKS", "OCC_BLOCK_BITS"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("op", ["row_and", "row_or", "row_andnot", "row_xor"])
def test_binary_row_ops(op):
    rng = np.random.default_rng(1)
    a, b = words(rng, port.WORDS), words(rng, port.WORDS)
    want = np.asarray(getattr(ref, op)(jnp.asarray(a), jnp.asarray(b)))
    got = back(getattr(port, op)(t(a), t(b)))
    np.testing.assert_array_equal(got, want)


def test_row_not():
    rng = np.random.default_rng(2)
    a = words(rng, port.WORDS)
    np.testing.assert_array_equal(
        back(port.row_not(t(a))), np.asarray(ref.row_not(jnp.asarray(a)))
    )


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_popcount_family(seed):
    rng = np.random.default_rng(seed)
    m = words(rng, (6, port.WORDS))
    r = words(rng, port.WORDS)
    jm, jr = jnp.asarray(m), jnp.asarray(r)
    assert int(port.popcount(t(r))) == int(ref.popcount(jr))
    assert int(port.popcount_and(t(m[0]), t(r))) == int(ref.popcount_and(jm[0], jr))
    np.testing.assert_array_equal(
        port.popcount_rows(t(m)).numpy(), np.asarray(ref.popcount_rows(jm))
    )
    np.testing.assert_array_equal(
        port.popcount_and_rows(t(m), t(r)).numpy(),
        np.asarray(ref.popcount_and_rows(jm, jr)),
    )
    np.testing.assert_array_equal(
        back(port.union_rows(t(m))), np.asarray(ref.union_rows(jm))
    )


@pytest.mark.parametrize("case", ["subset", "permutation", "one_row", "all_in_order", "repeats"])
def test_popcount_and_rows_by_index(case):
    """popcount_and_rows(matrix, row, rows=...) reads the named rows in
    place; the reference scores the gathered rows (fragment.go top :1089's
    batched form, as pilosa_tpu/core/fragment.py:1596-1600 calls it)."""
    rng = np.random.default_rng(9)
    R = 12
    m = words(rng, (R, port.WORDS))
    m[3] = 0xFFFFFFFF
    m[5] = 0x80000000
    r = words(rng, port.WORDS)
    rows = {
        "subset": [7, 3, 11, 0],
        "permutation": rng.permutation(R).tolist(),
        "one_row": [5],
        "all_in_order": list(range(R)),  # the same counts as rows=None
        "repeats": [3, 3, 5, 0, 5],
    }[case]
    want = np.asarray(ref.popcount_and_rows(jnp.asarray(m[rows]), jnp.asarray(r)))
    got = port.popcount_and_rows(t(m), t(r), rows=rows)
    assert got.dtype == torch.int32 and got.shape == (len(rows),)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "all_in_order":
        np.testing.assert_array_equal(port.popcount_and_rows(t(m), t(r)).numpy(), want)


def test_popcount_words_every_special_word():
    got = port.popcount_words(t(SPECIAL)).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(SPECIAL))


@pytest.mark.parametrize("n_bits", [0, 1, 31, 32, 33, 1000, 65535, port.SHARD_WIDTH - 1,
                                    port.SHARD_WIDTH])
def test_mask_first_n(n_bits):
    rng = np.random.default_rng(6)
    a = words(rng, port.WORDS)
    np.testing.assert_array_equal(
        back(port.mask_first_n(t(a), n_bits)),
        np.asarray(ref.mask_first_n(jnp.asarray(a), n_bits)),
    )


def test_host_helpers_match():
    rng = np.random.default_rng(7)
    pos = np.unique(rng.integers(0, port.SHARD_WIDTH, 3000))
    w = ref.positions_to_words(pos)
    np.testing.assert_array_equal(port.positions_to_words(pos), w)
    np.testing.assert_array_equal(port.words_to_positions(w), ref.words_to_positions(w))
    assert port.popcount_np(w) == ref.popcount_np(w)
    assert port.occupancy64(w) == ref.occupancy64(w)
    assert port.occupancy64_from_positions(pos) == ref.occupancy64_from_positions(pos)
    assert port.occupancy64_from_positions(pos[:0]) == 0


def test_tensor_round_trip_is_bit_identical():
    rng = np.random.default_rng(8)
    w64 = rng.integers(0, 1 << 64, port.WORDS64, dtype=np.uint64)
    x = port.to_tensor(w64, "cpu")
    assert x.dtype == torch.int32 and x.shape == (port.WORDS,)
    np.testing.assert_array_equal(port.to_numpy(x), w64.view(np.uint32))
    assert port.empty_row("cpu").sum() == 0
    assert int(port.popcount(port.full_row("cpu"))) == port.SHARD_WIDTH


def test_import_is_jax_free():
    """In a fresh interpreter with JAX blocked, every module of the port
    imports, the TopN and BSI paths (engine, executor lanes, kernel
    wrappers and their CUDA sources) are present and run queries on the
    CPU, a fused drain (``parallel/fusion.py``) answers, the API answers a
    keyed query, the node's modules (server, config, cli, __main__ and
    every net module) import and serve a keyed query over HTTP, the
    residency modules (``parallel/residency.py``, ``parallel/errors.py``)
    serve a query under a budget below one stack (a miss, the promotion,
    then the query warm from the pool), process mode and the query plans
    (``net.ipc``, ``net.worker``, ``net.procserver``, ``util.plans``,
    ``util.plan_miner``) import and record a profiled query's plan, the
    observability modules (``util.heat``, ``parallel.advisor``,
    ``util.history``, ``util.slo``, ``net.faults``, ``util.statsd``,
    ``util.diagnostics``, ``util.fanout``) import, a budgeted query records
    heat, drives an advisor promotion and ticks the history once, the
    repair-on-write modules (``core.delta``, ``parallel.repair``,
    ``net.cq``) import and a Count after a write is served by a repair with
    no dispatch, the cluster modules (``cluster.cluster``, ``gossip``,
    ``hints``, ``syncer``, ``harness`` and ``net.privproto``) import, a
    cluster message round-trips and placement answers, K9's wrapper and
    library are present, and no module of pilosa_tpu is loaded."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import pilosa_tpu_torch\n"
        "for m in pkgutil.walk_packages(pilosa_tpu_torch.__path__, 'pilosa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from pilosa_tpu_torch.parallel import build, kernels\n"
        "from pilosa_tpu_torch.parallel.engine import TorchEngine, decode_topn_full\n"
        "from pilosa_tpu_torch.executor import Executor\n"
        "from pilosa_tpu_torch.core.holder import Holder\n"
        "for name in ('score_rows', 'topn_tree', 'topn_full_tree', 'score_rows_cuda',\n"
        "             'and_popcount_rows_cuda', 'topn_trim_plain', 'topn_full_tree_plain'):\n"
        "    assert callable(getattr(kernels, name)), name\n"
        "assert not hasattr(kernels, 'topn_trim_cuda'), 'the trim runs in K3'\n"
        "assert set(build.KERNELS) >= {'score_rows', 'and_popcount_rows', 'sum_tree',\n"
        "                              'minmax_tree'}\n"
        "from pilosa_tpu_torch.parallel import bsi\n"
        "from pilosa_tpu_torch.ops import bsi as bsi_ops\n"
        "for name in ('sum_tree', 'minmax_tree', 'sum_tree_cuda', 'minmax_tree_cuda',\n"
        "             'sum_tree_plain', 'minmax_tree_plain', 'decode_sum', 'decode_min_max'):\n"
        "    assert callable(getattr(bsi, name)), name\n"
        "for name in ('range_eq', 'range_neq', 'range_lt', 'range_gt', 'range_between',\n"
        "             'sum_counts', 'minmax_valcount_nd', 'min_valcount', 'max_valcount'):\n"
        "    assert callable(getattr(bsi_ops, name)), name\n"
        "assert 'topn_trim' not in build.KERNELS\n"
        "assert all((build.CSRC / f'{k}.cu').is_file() for k in build.KERNELS)\n"
        "h = Holder(device='cpu'); h.open()\n"
        "f = h.create_index('i').create_field('t')\n"
        "f.import_bulk([1, 1, 2], [3, 4, 3])\n"
        "ex = Executor(h, engine=TorchEngine(h, device='cpu'))\n"
        "assert ex.execute('i', 'TopN(t, Row(t=2), n=2)').results[0] == [(2, 1), (1, 1)]\n"
        "assert Executor(h).execute('i', 'TopN(t, n=1)').results[0] == [(1, 2)]\n"
        "from pilosa_tpu_torch.core.field import FieldOptions\n"
        "v = h.index('i').create_field('v', FieldOptions(type='int', min=-5, max=9))\n"
        "v.import_values([3, 4, 9], [-5, 9, 2])\n"
        "assert ex.execute('i', 'Count(Range(v > 0))').results[0] == 2\n"
        "assert ex.execute('i', 'Sum(field=v)').results[0].to_dict() == {'value': 6, 'count': 3}\n"
        "from pilosa_tpu_torch.api import API, ImportRequest, QueryRequest\n"
        "a = API(device='cpu'); a.create_index('k', keys=True)\n"
        "a.create_field('k', 'f', {'keys': True})\n"
        "a.import_bits(ImportRequest('k', 'f', row_keys=['x', 'x'], column_keys=['c', 'd']))\n"
        "assert a.query(QueryRequest('k', 'Row(f=\"x\")')).results[0].keys == ['c', 'd']\n"
        "a.close()\n"
        "from pilosa_tpu_torch.parallel import fusion\n"
        "for name in ('build', 'dispatch', 'pack', 'unpack', 'op_signature', 'item_texts'):\n"
        "    assert callable(getattr(fusion, name)), name\n"
        "for name in ('fused_tree', 'fused_tree_cuda', 'fused_tree_plain', 'compile_fused'):\n"
        "    assert callable(getattr(kernels, name)), name\n"
        "assert 'fused_tree' in build.KERNELS\n"
        "eng = ex.engine\n"
        "got = eng.fused_many('i', [({'kind': 'sum', 'field': 'v', 'filter': None}, [0]),\n"
        "                           ({'kind': 'count', 'call': ex._parse_cached('Row(t=1)').calls[0]},\n"
        "                            [0])])\n"
        "assert got == [(6, 3), 2], got\n"
        "for name in ('server', 'config', 'cli', '__main__', 'net', 'net.server', 'net.aserver',\n"
        "             'net.wire', 'net.proto', 'net.admission', 'net.client'):\n"
        "    importlib.import_module('pilosa_tpu_torch.' + name)\n"
        "from pilosa_tpu_torch.net import InternalClient, serve\n"
        "a = API(device='cpu'); a.create_index('k', keys=True)\n"
        "srv, _ = serve(a, 'localhost', 0)\n"
        "c = InternalClient(f'http://localhost:{srv.server_address[1]}')\n"
        "c.create_field('k', 'f', {'keys': True})\n"
        "c.query('k', 'Set(\"c\", f=\"x\") Set(\"d\", f=\"x\")')\n"
        "assert c.query('k', 'Row(f=\"x\")')['results'][0]['keys'] == ['c', 'd']\n"
        "srv.shutdown(); a.close()\n"
        "from pilosa_tpu_torch.parallel import errors, residency\n"
        "assert issubclass(errors.ResidencyMiss, errors.HostFallback)\n"
        "assert residency.MAX_PENDING == 64 and residency.DECLINE_COOLDOWN == 5.0\n"
        "hr = Holder(device='cpu'); hr.open()\n"
        "g = hr.create_index('r').create_field('g')\n"
        "g.import_bulk([r for r in range(8) for _ in range(3)], [c for r in range(8) for c in (r, 9, 20)])\n"
        "one = 32768 * 4 + 16\n"
        "er = TorchEngine(hr, device='cpu', max_resident_bytes=4 * one)\n"
        "er.result_memo.maxsize = 0\n"
        "xr = Executor(hr, engine=er)\n"
        "q = 'Count(Union(Row(g=1), Row(g=2)))'\n"
        "assert xr.execute('r', q).results[0] == 4 and er.host_fallbacks == 1\n"
        "assert er.residency.flush(30.0)\n"
        "assert er._stacks[('r', 'g', 'standard')].pool\n"
        "assert xr.execute('r', q).results[0] == 4 and er.host_fallbacks == 1\n"
        "er.close()\n"
        "for name in ('net.ipc', 'net.worker', 'net.procserver', 'util.plans',\n"
        "             'util.plan_miner'):\n"
        "    importlib.import_module('pilosa_tpu_torch.' + name)\n"
        "from pilosa_tpu_torch.net import ipc, procserver, worker\n"
        "from pilosa_tpu_torch.util import plan_miner, plans\n"
        "assert procserver.ProcessHTTPServer and worker.EngineLink and ipc.QUERY == 2\n"
        "a = API(device='cpu'); a.create_index('p').create_field('f').import_bulk([1, 2], [5, 5])\n"
        "r = a.query(QueryRequest('p', 'Count(Intersect(Row(f=1), Row(f=2)))', profile=True))\n"
        "assert r.results == [1] and r.plan['ops'][0]['path'] == 'sparse', r.plan\n"
        "assert plans.STORE.recorded >= 1 and plan_miner.MINER.observed >= 1\n"
        "a.close()\n"
        "for name in ('util.heat', 'parallel.advisor', 'util.history', 'util.slo', 'net.faults',\n"
        "             'util.statsd', 'util.diagnostics', 'util.fanout'):\n"
        "    importlib.import_module('pilosa_tpu_torch.' + name)\n"
        "import gc\n"
        "from pilosa_tpu_torch.parallel.advisor import ADVISOR\n"
        "from pilosa_tpu_torch.util.heat import HEAT\n"
        "from pilosa_tpu_torch.util.history import HistorySampler\n"
        "from pilosa_tpu_torch.util.slo import SLOWatcher\n"
        "hh = Holder(device='cpu'); hh.open(); ix = hh.create_index('h')\n"
        "for name in ('a', 'b'):\n"
        "    ix.create_field(name).import_bulk([r for r in range(16) for _ in range(2)],\n"
        "                                      [c + (r % 8) * 16384 for r in range(16) for c in (0, 2)])\n"
        "eh = TorchEngine(hh, device='cpu', max_resident_bytes=24 * 1024)\n"
        "eh.result_memo.maxsize = 0\n"
        "split = eh.residency_row_split  # a miss's promotion lands before the advice reads\n"
        "eh.residency_row_split = lambda key, rows: (eh.residency.flush(30.0), split(key, rows))[1]\n"
        "ah = API(holder=hh, engine=eh)\n"
        "for k in range(6):\n"
        "    qh = 'Count(Intersect(Row(a=2), Row(a=10)))' if k % 2 == 0 else 'Count(Intersect(Row(b=4), Row(b=12)))'\n"
        "    assert ah.query(QueryRequest('h', qh)).results == [2]\n"
        "    assert eh.residency.flush(30.0); gc.collect()\n"
        "assert HEAT.totals()['plansObserved'] >= 6 and HEAT.to_doc('h')['tables']\n"
        "assert ADVISOR.driven_requests >= 1, ADVISOR.to_doc()\n"
        "assert 'advisor' in {e.fields.get('cause') for e in eh.journal.events(type='engine.promotion')}\n"
        "hs = HistorySampler(ah, interval=1.0)\n"
        "assert hs.tick(now=1.7e9) > 0 and 'pilosa_engine_residency_gap_bytes' in hs.series_names()\n"
        "SLOWatcher(ah, hs, error_rate_target=0.01).tick(now=1.7e9)\n"
        "ah.close()\n"
        "for name in ('core.delta', 'parallel.repair', 'net.cq'):\n"
        "    importlib.import_module('pilosa_tpu_torch.' + name)\n"
        "from pilosa_tpu_torch.net.cq import CQManager\n"
        "from pilosa_tpu_torch.core.delta import HUB\n"
        "hq = Holder(device='cpu'); hq.open()\n"
        "hq.create_index('q').create_field('f').import_bulk([1, 1, 2], [3, 4, 3])\n"
        "eq = TorchEngine(hq, device='cpu')\n"
        "cq = ex._parse_cached('Intersect(Row(f=1), Row(f=2))').calls[0]\n"
        "assert eq.count('q', cq, [0]) == 1\n"
        "hq.fragment('q', 'f', 'standard', 0).set_bit(2, 4)\n"
        "n = eq.dense_dispatches + eq.sparse_dispatches\n"
        "assert eq.count('q', cq, [0]) == 2 and eq.repairs.repaired['count'] == 1\n"
        "assert eq.dense_dispatches + eq.sparse_dispatches == n\n"
        "aq = API(holder=hq, engine=eq)\n"
        "assert isinstance(aq.cq, CQManager) and aq.cq.create('q', 'Count(Row(f=1))')['result'] == [2]\n"
        "logs = HUB.snapshot()['viewLogs']\n"
        "aq.close()\n"
        "assert HUB.snapshot()['viewLogs'] == logs - 1\n"
        "from pilosa_tpu_torch.cluster import Cluster, Node, jump_hash, place_partition\n"
        "from pilosa_tpu_torch.cluster import gossip, hints, syncer, harness\n"
        "from pilosa_tpu_torch.net import privproto\n"
        "msg = {'type': 'create-shard', 'index': 'i', 'field': 'f', 'shard': 3}\n"
        "assert privproto.unmarshal_cluster_message(privproto.marshal_cluster_message(msg)) == msg\n"
        "c = Cluster(Node('a', 'http://a'), replica_n=2)\n"
        "c.nodes = [Node('a', 'http://a'), Node('b', 'http://b'), Node('c', 'http://c')]\n"
        "assert len(c.shard_nodes('i', 7)) == 2 and jump_hash(1, 10) in range(10)\n"
        "assert callable(kernels.topn_slab_tree) and 'topn_slab' in build.KERNELS\n"
        "assert callable(TorchEngine.topn_device_full)\n"
        "bad = [m for m in sys.modules if m == 'pilosa_tpu' or m.startswith('pilosa_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
