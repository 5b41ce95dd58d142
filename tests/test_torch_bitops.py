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
    imports, the TopN path (engine, executor lanes, kernel wrappers and
    their CUDA sources) is present and runs a query on the CPU, and no
    module of pilosa_tpu is loaded."""
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
        "             'topn_trim_cuda', 'and_popcount_rows_cuda', 'topn_trim_plain'):\n"
        "    assert callable(getattr(kernels, name)), name\n"
        "assert set(build.KERNELS) >= {'score_rows', 'topn_trim'}\n"
        "assert all((build.CSRC / f'{k}.cu').is_file() for k in build.KERNELS)\n"
        "h = Holder(device='cpu'); h.open()\n"
        "f = h.create_index('i').create_field('t')\n"
        "f.import_bulk([1, 1, 2], [3, 4, 3])\n"
        "ex = Executor(h, engine=TorchEngine(h, device='cpu'))\n"
        "assert ex.execute('i', 'TopN(t, Row(t=2), n=2)').results[0] == [(2, 1), (1, 1)]\n"
        "assert Executor(h).execute('i', 'TopN(t, n=1)').results[0] == [(1, 2)]\n"
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
