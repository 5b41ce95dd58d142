#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (pilosa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit) when it fails:

1. build — nvcc compiles every kernel source under pilosa_tpu_torch/csrc/
   (one nvcc per source, all started together) into build/torch_kernels/.
2. kernels — K1 count_tree_dense and K2 count_tree_blocks against their
   plain PyTorch versions on the card: random and adversarial words
   (all-ones, sign-bit-only, zero), masked shards, ragged block lists and
   every Kb tier.  Integer counts, so they must agree exactly.
3. main path — the north-star index of bench.py at full scale: index
   "bench" of 960 shards (~1.007B columns), field f of 24 dense random rows
   and field s of 24 rows that each occupy 4 of the 64 occupancy blocks of
   every shard.  Executor.execute answers Count(Intersect(...)) for the 12
   disjoint row pairs of each field plus one Union/Difference/Xor tree
   each; every answer is checked against a numpy oracle over the host
   words, f must take the dense path (K1) and s the sparse path (K2), and
   both kernels' launch counters must have moved during this phase.
4. times — each kernel's p50 at the main path's shapes beside its bound,
   its plain version's p50, the end-to-end Count p50, and the card's name
   and power limit.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs one card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_SHARDS = 960  # 960 * 2^20 = ~1.007B columns (bench.py:66)
W64 = 16384  # uint64 words per 2^20-bit shard row
F_ROWS = range(10, 34)  # 24 rows -> 12 disjoint pairs (bench.py:66-75)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (fp32 table entry)
BLOCKS_PER_ROW = 4  # occupied blocks of each sparse row, per shard
BLOCK_POOL = 8  # per shard, the sparse rows draw their blocks from 8


def log(msg):
    print(msg, flush=True)


def p50_ms(fn, reps, sync, batch=10):
    """Per-call device time of ``fn``: CUDA events around ``batch`` calls
    back to back (so the host's launch cost overlaps the device's work),
    divided by ``batch``; the p50 over ``reps`` such runs."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


# -- phase 2: kernels against their plain versions ---------------------------


def _adversarial_stack(rng, R, S, device):
    import torch

    words = rng.integers(0, 1 << 32, (R, S, 32768), dtype=np.uint64).astype(np.uint32)
    words[0, 0] = 0xFFFFFFFF
    words[1, 0] = 0x80000000
    words[2, 1] = 0
    words[1, 2, ::2] = 0xFFFFFFFF
    # Sparse rows: only a few occupancy blocks hold bits.
    for s in range(S):
        keep = rng.choice(64, 3, replace=False)
        row = words[R - 1, s].reshape(64, 512)
        mask = np.zeros(64, dtype=bool)
        mask[keep] = True
        row[~mask] = 0
    return torch.from_numpy(words.view(np.int32)).to(device)


KERNEL_PROGS = [
    ("and", ("row", 0, 0), ("row", 0, 1)),
    ("or", ("row", 0, 0), ("row", 0, 1), ("row", 1, 2)),
    ("andnot", ("row", 0, 1), ("row", 1, 0)),
    ("xor", ("row", 0, 2), ("row", 0, 3), ("row", 1, 1)),
    ("and", ("row", 0, 0), ("zero",)),
    ("or", ("zero",), ("row", 1, 3)),
    ("andnot", ("or", ("row", 0, 0), ("row", 1, 1)),
     ("and", ("row", 0, 2), ("xor", ("row", 1, 2), ("row", 0, 3)))),
    ("and", ("row", 0, 1), ("row", 0, 1)),
    ("row", 1, 2),
    ("xor", ("and", ("or", ("row", 0, 0), ("zero",)), ("row", 0, 3)),
     ("andnot", ("row", 1, 0), ("or", ("row", 1, 1), ("row", 0, 2)))),
]


def check_kernels(device, seed):
    """K1 and K2 against their plain versions; returns max |err| of each."""
    import torch

    from pilosa_tpu_torch.parallel import kernels, sparse

    rng = np.random.default_rng(seed)
    S = 12
    mats = [_adversarial_stack(rng, 4, S, device), _adversarial_stack(rng, 4, S, device)]
    masks = [
        np.ones(S, np.int32),
        np.zeros(S, np.int32),
        (rng.random(S) < 0.5).astype(np.int32),
    ]
    err = {"count_tree_dense": 0, "count_tree_blocks": 0}
    n = 0
    for prog in KERNEL_PROGS:
        code = kernels.compile_prog(prog)
        for m in masks:
            mask = torch.from_numpy(m).to(device)
            got = kernels.count_tree_dense(code, mats, mask)
            torch.cuda.synchronize()
            want = kernels.count_tree_plain(prog, mats, mask)
            e = abs(int(got) - int(want))
            err["count_tree_dense"] = max(err["count_tree_dense"], e)
            if e:
                raise AssertionError(f"K1 {prog} mask={m.tolist()}: {int(got)} != {int(want)}")
            n += 1
        for kb in (1, 2, 4, 8, 16, 32, 64):
            blk_n = rng.integers(0, kb + 1, S).astype(np.int32)
            blk_n[0] = kb
            blk_n[1] = 0
            blk_idx = np.zeros((S, kb), np.int32)
            for s in range(S):
                ids = np.sort(rng.choice(64, blk_n[s], replace=False)) if blk_n[s] else []
                blk_idx[s, : len(ids)] = ids
            bi = torch.from_numpy(blk_idx).to(device)
            bn = torch.from_numpy(blk_n).to(device)
            got = sparse.count_tree_blocks_cuda(code, mats, bi, bn)
            torch.cuda.synchronize()
            want = sparse.count_tree_blocks_plain(prog, mats, bi, bn)
            e = abs(int(got) - int(want))
            err["count_tree_blocks"] = max(err["count_tree_blocks"], e)
            if e:
                raise AssertionError(f"K2 {prog} Kb={kb}: {int(got)} != {int(want)}")
            n += 1
    # The dense and sparse forms agree when every block is listed.
    full_idx = torch.arange(64, dtype=torch.int32, device=device).repeat(S, 1).contiguous()
    full_n = torch.full((S,), 64, dtype=torch.int32, device=device)
    for prog in KERNEL_PROGS:
        code = kernels.compile_prog(prog)
        a = int(kernels.count_tree_dense(code, mats, torch.ones(S, dtype=torch.int32, device=device)))
        b = int(sparse.count_tree_blocks_cuda(code, mats, full_idx, full_n))
        torch.cuda.synchronize()
        if a != b:
            raise AssertionError(f"K1 {a} != K2 over all blocks {b} for {prog}")
        n += 1
    # A too-deep tree is refused before launch.
    deep = ("row", 0, 0)
    for _ in range(kernels.MAX_STACK):
        deep = ("and", ("row", 0, 1), deep)
    try:
        kernels.count_tree(deep, mats, torch.ones(S, dtype=torch.int32, device=device))
    except ValueError:
        pass
    else:
        raise AssertionError("a tree deeper than the kernel stack was launched")
    log(f"kernels: {n} comparisons exact (K1 and K2 against plain versions)")
    return err


# -- phase 3: the main path --------------------------------------------------


def build_index(holder, n_shards, seed):
    """Index "bench": field f (24 dense random rows) and field s (24 rows,
    each on 4 of the 64 blocks of every shard).  Returns the host words,
    {field: {row: uint64[S, W64]}} — the very arrays the fragments hold."""
    from pilosa_tpu_torch.core.view import VIEW_STANDARD

    rng = np.random.default_rng(seed)
    idx = holder.create_index("bench")
    host = {"f": {}, "s": {}}
    f = idx.create_field("f")
    s_field = idx.create_field("s")
    for r in F_ROWS:
        host["f"][r] = rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64)
        rows = np.zeros((n_shards, W64), dtype=np.uint64)
        host["s"][r] = rows
    pools = np.stack([rng.choice(64, BLOCK_POOL, replace=False) for _ in range(n_shards)])
    for r in F_ROWS:
        rows = host["s"][r].reshape(n_shards, 64, 256)
        for sh in range(n_shards):
            for b in rng.choice(pools[sh], BLOCKS_PER_ROW, replace=False):
                rows[sh, b] = rng.integers(0, 1 << 64, 256, dtype=np.uint64)
    for name, field in (("f", f), ("s", s_field)):
        view = field.view_if_not_exists(VIEW_STANDARD)
        for sh in range(n_shards):
            frag = view.fragment_if_not_exists(sh)
            for r in F_ROWS:
                frag.load_row_words(r, host[name][r][sh])
    return host


def oracle(host, op, rows):
    from pilosa_tpu_torch.ops.bitops import popcount_np

    acc = host[rows[0]]
    for r in rows[1:]:
        b = host[r]
        if op == "and":
            acc = acc & b
        elif op == "or":
            acc = acc | b
        elif op == "andnot":
            acc = acc & ~b
        else:
            acc = acc ^ b
    return popcount_np(acc)


_PQL = {"and": "Intersect", "or": "Union", "andnot": "Difference", "xor": "Xor"}


def main_path_queries():
    qs = []
    for field in ("f", "s"):
        for k in range(12):
            qs.append((field, "and", (10 + 2 * k, 11 + 2 * k)))
        qs.append((field, "or", (12, 15, 20)))
        qs.append((field, "andnot", (14, 17)))
        qs.append((field, "xor", (22, 23, 30)))
    return qs


def pql_of(field, op, rows):
    inner = ", ".join(f"Row({field}={r})" for r in rows)
    return f"Count({_PQL[op]}({inner}))"


def run_main_path(device, n_shards, seed):
    import torch

    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.parallel import kernels, sparse
    from pilosa_tpu_torch.parallel.engine import TorchEngine

    t0 = time.perf_counter()
    holder = Holder(device=device)
    host = build_index(holder, n_shards, seed)
    log(f"main path: data made in {time.perf_counter() - t0:.3f} s "
        f"({n_shards} shards, {n_shards << 20} columns)")
    engine = TorchEngine(holder, device=device)
    ex = Executor(holder, engine=engine)
    for field in ("f", "s"):
        t0 = time.perf_counter()
        st = engine.field_stack("bench", field, "standard")
        if device.type == "cuda":
            torch.cuda.synchronize()
        log(f"main path: stack {field} {tuple(st.matrix.shape)} "
            f"({st.matrix.numel() * 4 / 1e9:.3f} GB) built and uploaded in "
            f"{time.perf_counter() - t0:.3f} s")
    kernels.count_tree_dense.launches = 0
    sparse.count_tree_blocks_cuda.launches = 0
    paths = {}
    for field, op, rows in main_path_queries():
        q = pql_of(field, op, rows)
        got = ex.execute("bench", q).results[0]
        want = oracle(host[field], op, rows)
        if got != want:
            raise AssertionError(f"{q}: port {got} != numpy oracle {want}")
        paths.setdefault(field, set()).add(engine.last_path)
    launches = {
        "count_tree_dense": kernels.count_tree_dense.launches,
        "count_tree_blocks": sparse.count_tree_blocks_cuda.launches,
    }
    log(f"main path: {len(main_path_queries())} Counts exact against numpy; "
        f"paths {({k: sorted(v) for k, v in paths.items()})}; launches {launches}")
    if paths != {"f": {"dense"}, "s": {"sparse"}}:
        raise AssertionError(f"unexpected dispatch paths: {paths}")
    return holder, engine, ex, host, launches


# -- phase 4: times ----------------------------------------------------------


def time_kernels(engine, ex, device, err, launches):
    import torch

    from pilosa_tpu_torch.parallel import kernels, sparse
    from pilosa_tpu_torch.parallel.engine import _Lowering
    from pilosa_tpu_torch import pql

    sync = torch.cuda.synchronize
    canonical = engine.canonical_shards("bench")
    S = len(canonical)
    out = []

    # K1 at the north-star shape: the 12 pairs of f in turn (each pair is
    # 251 MB, five times the L2 cache, so every launch reads from memory).
    progs = []
    lw = _Lowering(engine, canonical)
    for k in range(12):
        c = pql.parse(f"Intersect(Row(f={10 + 2 * k}), Row(f={11 + 2 * k}))").calls[0]
        progs.append(engine._lower("bench", c, lw))
    codes = [kernels.compile_prog(p) for p in progs]
    mask = engine._mask_words(canonical, canonical)
    for prog, code in zip(progs, codes):  # held against plain at this shape
        got = int(kernels.count_tree_dense(code, lw.mats, mask))
        e = abs(got - int(kernels.count_tree_plain(prog, lw.mats, mask)))
        err["count_tree_dense"] = max(err["count_tree_dense"], e)
        if e:
            raise AssertionError(f"K1 at the main-path shape: {prog} off by {e}")
    it = iter(range(10 ** 9))
    for _ in range(5):
        kernels.count_tree_dense(codes[0], lw.mats, mask)
    sync()
    k1 = p50_ms(lambda: kernels.count_tree_dense(codes[next(it) % 12], lw.mats, mask), 15, sync)
    plain1 = p50_ms(lambda: kernels.count_tree_plain(progs[next(it) % 12], lw.mats, mask), 5, sync, batch=2)
    # Least time: each leaf row's words of the requested shards read once,
    # plus the mask and the result; about four integer ops per word.
    words = 2 * S * 32768
    bytes1 = words * 4 + S * 4 + 8
    ops1 = words * 4
    bound1 = max(bytes1 / HBM_BYTES_PER_S, ops1 / INT_OPS_PER_S) * 1e3
    out.append({
        "name": "count_tree_dense", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/count_tree_dense.cu",
        "replaces": "pilosa_tpu/parallel/kernels.py:242",
        "launches": launches["count_tree_dense"],
        "max_abs_err": err["count_tree_dense"],
        "ms": k1, "plain_ms": plain1, "bound_ms": bound1,
        "bound_by": "bytes" if bytes1 / HBM_BYTES_PER_S >= ops1 / INT_OPS_PER_S else "operations",
        "library_ms": None,
    })

    # K2 at the sparse main path's shape: the 12 pairs of s.
    lw2 = _Lowering(engine, canonical)
    plans = []
    for k in range(12):
        c = pql.parse(f"Intersect(Row(s={10 + 2 * k}), Row(s={11 + 2 * k}))").calls[0]
        prog = engine._lower("bench", c, lw2)
        blk_idx, blk_n, _ = engine._sparse_plan(prog, lw2, canonical, canonical)
        plans.append((prog, kernels.compile_prog(prog),
                      torch.from_numpy(blk_idx).to(device),
                      torch.from_numpy(blk_n).to(device)))
    for prog, code, bi, bn in plans:  # held against plain at this shape
        got = int(sparse.count_tree_blocks_cuda(code, lw2.mats, bi, bn))
        e = abs(got - int(sparse.count_tree_blocks_plain(prog, lw2.mats, bi, bn)))
        err["count_tree_blocks"] = max(err["count_tree_blocks"], e)
        if e:
            raise AssertionError(f"K2 at the main-path shape: {prog} off by {e}")
    for _ in range(5):
        sparse.count_tree_blocks_cuda(plans[0][1], lw2.mats, plans[0][2], plans[0][3])
    sync()

    def k2_call():
        _, code, bi, bn = plans[next(it) % 12]
        return sparse.count_tree_blocks_cuda(code, lw2.mats, bi, bn)

    def k2_plain():
        prog, _, bi, bn = plans[next(it) % 12]
        return sparse.count_tree_blocks_plain(prog, lw2.mats, bi, bn)

    k2 = p50_ms(k2_call, 15, sync)
    plain2 = p50_ms(k2_plain, 5, sync, batch=2)
    # Least time per plan: each listed 2 KiB block of both leaves read
    # once, plus the block lists and the result; the median over the 12.
    bounds2, bytes2_all, ops2_all = [], [], []
    for _, _, bi, bn in plans:
        blocks = int(bn.sum())
        b = 2 * blocks * 2048 + bi.numel() * 4 + bn.numel() * 4 + 8
        o = 2 * blocks * 512 * 4
        bytes2_all.append(b)
        ops2_all.append(o)
        bounds2.append(max(b / HBM_BYTES_PER_S, o / INT_OPS_PER_S) * 1e3)
    bound2 = statistics.median(bounds2)
    blocks = statistics.median(int(bn.sum()) for _, _, _, bn in plans)
    by_bytes = statistics.median(bytes2_all) / HBM_BYTES_PER_S >= statistics.median(ops2_all) / INT_OPS_PER_S
    out.append({
        "name": "count_tree_blocks", "route": "cuda",
        "source": "pilosa_tpu_torch/csrc/count_tree_blocks.cu",
        "replaces": "pilosa_tpu/parallel/sparse.py:164",
        "launches": launches["count_tree_blocks"],
        "max_abs_err": err["count_tree_blocks"],
        "ms": k2, "plain_ms": plain2, "bound_ms": bound2,
        "bound_by": "bytes" if by_bytes else "operations",
        "library_ms": None,
    })
    log(f"times: K1 p50 {k1:.4f} ms (bound {bound1:.4f} ms, plain {plain1:.3f} ms); "
        f"K2 p50 {k2:.4f} ms over a median {blocks} blocks per leaf "
        f"(bound {bound2:.4f} ms, plain {plain2:.3f} ms)")

    # End to end: Executor.execute of the 12 north-star Counts, host clock
    # around a synchronous answer (parse cache warm, stacks resident).
    for field in ("f", "s"):
        qs = [pql_of(field, "and", (10 + 2 * k, 11 + 2 * k)) for k in range(12)]
        lat = []
        for rep in range(4):
            for q in qs:
                t0 = time.perf_counter()
                ex.execute("bench", q)
                lat.append((time.perf_counter() - t0) * 1e3)
        log(f"times: end-to-end Count(Intersect) on {field} p50 "
            f"{statistics.median(lat):.4f} ms over {len(lat)} queries")
    return out


def card_line():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from pilosa_tpu_torch.parallel import build
    except ImportError as e:
        print(f"chip_smoke: pilosa_tpu_torch not found beside this script: {e}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = build.build(build.KERNELS)
    log(f"build: {time.perf_counter() - t0:.3f} s "
        f"({', '.join(f'{k} {v:.3f} s' for k, v in built.items()) or 'cached'})")

    err = check_kernels(device, args.seed)
    _holder, engine, ex, _host, launches = run_main_path(device, N_SHARDS, args.seed)
    for v in launches.values():
        if v <= 0:
            raise AssertionError(f"a kernel of the main path never launched: {launches}")
    kern = time_kernels(engine, ex, device, err, launches)
    log(card_line())
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
