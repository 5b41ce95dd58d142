#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (pilosa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit) when it fails:

1. build — nvcc compiles every kernel source under pilosa_tpu_torch/csrc/
   (one nvcc per source, all started together) into build/torch_kernels/.
2. kernels — K1 count_tree_dense and K2 count_tree_blocks, K3 score_rows,
   K4 topn_trim and P2 (K3's and_popcount_rows entry) against their plain
   PyTorch versions on the card: random and adversarial words (all-ones,
   sign-bit-only, zero), masked shards, ragged block lists and every Kb
   tier; for K3 K in {1, 8, 16, 128, 129, 4096}, pad and absent slots,
   zero and multi-leaf src trees; for K4 ties and all-zero totals.
   Integer results, so they must agree exactly.
3. main path — the north-star index of bench.py at full scale: index
   "bench" of 960 shards (~1.007B columns), field f of 24 dense random rows,
   field s of 24 rows that each occupy 4 of the 64 occupancy blocks of
   every shard, and field top of 16 rows rand & rand (bench.py:434-438).
   Count: Executor.execute answers Count(Intersect(...)) for the 12
   disjoint row pairs of f and s plus one Union/Difference/Xor tree each;
   f must take the dense path (K1) and s the sparse path (K2).  TopN:
   TopN(top, <src>, n=5) for several src rows and an Intersect, a
   threshold= query, an ids= query, a no-src query and a Tanimoto query
   (the two-phase lane), through the engine (K3, K4), then one TopN through
   an engine-less Executor (Fragment.top per shard: P2).  Every answer
   equals a numpy oracle over the host words, and each path's kernels'
   launch counters, zeroed just before it, must have moved.
4. times — each kernel's p50 at the main path's shapes beside its bound,
   its plain version's p50 (and a library call's where one computes the
   same function), P2 at scripts/pallas_vs_xla.py's shapes, the
   end-to-end Count and TopN p50s, and the card's name and power limit.

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
TOP_ROWS = range(16)  # field top: 16 TopN candidate rows (bench.py:70,434-438)


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


TOPN_SRC_PROGS = [
    ("row", 0, 1),
    ("andnot", ("or", ("row", 0, 0), ("row", 1, 1)), ("row", 0, 2)),
    ("xor", ("row", 0, 2), ("row", 1, 3), ("row", 0, 0)),
    ("zero",),
]


def _exact(name, got, want, what):
    import torch

    e = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if got.shape != want.shape or not torch.equal(got.long(), want.long()):
        raise AssertionError(f"{name} {what}: disagrees with its plain version (max |err| {e})")
    return e


def check_topn_kernels(device, seed):
    """K3 (topn_tree and gated totals), K4 and P2 against their plain
    versions; returns max |err| of each."""
    import torch

    from pilosa_tpu_torch.ops import bitops
    from pilosa_tpu_torch.parallel import kernels

    rng = np.random.default_rng(seed + 1)
    S, R = 6, 8
    mats = [_adversarial_stack(rng, 4, S, device), _adversarial_stack(rng, 4, S, device)]
    cand = _adversarial_stack(rng, R, S, device)
    masks = [np.ones(S, np.int32), np.zeros(S, np.int32), (rng.random(S) < 0.5).astype(np.int32)]
    masks[2][0] = 1
    err = {"score_rows": 0, "topn_trim": 0, "and_popcount_rows": 0}
    n = 0
    for K in (1, 8, 16, 128, 129, 4096):
        idx = rng.integers(0, R, K).astype(np.int32)
        idx[K // 2:] = 0  # the later half: pad / absent slots, reading row 0
        cnt = rng.integers(0, 1 << 20, (K, S)).astype(np.int32)
        cnt[K // 2:] = 0
        ci = torch.from_numpy(idx).to(device)
        cn = torch.from_numpy(cnt).to(device)
        for prog in TOPN_SRC_PROGS if K <= 129 else TOPN_SRC_PROGS[:2]:
            code = kernels.compile_prog(prog)
            for m in masks if K <= 129 else masks[2:]:
                mask = torch.from_numpy(m).to(device)
                scores, counts, _ = kernels.score_rows_cuda(code, mats, mask, cand, ci, src_counts=True)
                torch.cuda.synchronize()
                ws, wc = kernels.topn_tree_plain(prog, mats, mask, cand, ci)
                err["score_rows"] = max(err["score_rows"], _exact("K3", scores, ws, f"scores K={K} {prog}"),
                                        _exact("K3", counts, wc, f"src counts K={K} {prog}"))
                for thr in (1, int(ws.float().mean()) + 1):
                    _, _, totals = kernels.score_rows_cuda(code, mats, mask, cand, ci, scores=False,
                                                           cnt=cn, thr=thr)
                    torch.cuda.synchronize()
                    want = kernels.topn_full_tree_plain(prog, mats, mask, cand, ci, cn, thr, None)
                    err["score_rows"] = max(err["score_rows"],
                                            _exact("K3", totals, want, f"totals K={K} thr={thr} {prog}"))
                    n += 1
                n += 1
    for K in (8, 16, 1024, 4096):
        cases = [rng.integers(0, 4, K), np.zeros(K, np.int64), rng.integers(0, 1 << 30, K)]
        for totals in cases:
            t = torch.from_numpy(totals.astype(np.int64)).to(device)
            for n_out in sorted({1, 5, K}):
                vals, idx = kernels.topn_trim_cuda(t, n_out)
                torch.cuda.synchronize()
                wv, wi = kernels.topn_trim_plain(t, n_out)
                err["topn_trim"] = max(err["topn_trim"], _exact("K4", vals, wv, f"vals K={K} n={n_out}"),
                                       _exact("K4", idx, wi, f"idx K={K} n={n_out}"))
                n += 1
    for R2 in (1, 8, 64):
        # Shard 0 of an adversarial stack: row 0 all-ones, row 1 sign bits.
        mat = _adversarial_stack(rng, max(R2, 4), 3, device)[:R2, 0].contiguous()
        for row in (mats[0][0, 1], mats[1][1, 0], torch.full((32768,), -1, dtype=torch.int32, device=device)):
            got = kernels.and_popcount_rows_cuda(mat, row)
            torch.cuda.synchronize()
            err["and_popcount_rows"] = max(
                err["and_popcount_rows"],
                _exact("P2", got, bitops.popcount_and_rows_plain(mat, row), f"R={R2}"))
            n += 1
    log(f"kernels: {n} comparisons exact (K3, K4 and P2 against plain versions)")
    return err


# -- phase 3: the main path --------------------------------------------------


def build_index(holder, n_shards, seed):
    """Index "bench": field f (24 dense random rows), field s (24 rows,
    each on 4 of the 64 blocks of every shard) and field top (16 rows rand
    & rand, density 1/4).  Returns the host words, {field: {row:
    uint64[S, W64]}} — the very arrays the fragments hold."""
    from pilosa_tpu_torch.core.view import VIEW_STANDARD

    rng = np.random.default_rng(seed)
    idx = holder.create_index("bench")
    host = {"f": {}, "s": {}, "top": {}}
    f = idx.create_field("f")
    s_field = idx.create_field("s")
    top = idx.create_field("top")
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
    for r in TOP_ROWS:
        host["top"][r] = rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64)
        host["top"][r] &= rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64)
    for name, field, rows in (("f", f, F_ROWS), ("s", s_field, F_ROWS), ("top", top, TOP_ROWS)):
        view = field.view_if_not_exists(VIEW_STANDARD)
        for sh in range(n_shards):
            frag = view.fragment_if_not_exists(sh)
            for r in rows:
                frag.load_row_words(r, host[name][r][sh])
            frag.cache.invalidate()  # once after the bulk load, as bench.py does
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


def popcounts(words):
    """Set bits of uint64[..., W64] host words summed over the last axis,
    int64[...] (numpy's bitwise_count, or SWAR where numpy lacks it)."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(words).sum(axis=-1, dtype=np.int64)
    u = np.uint64
    x = words - ((words >> u(1)) & u(0x5555555555555555))
    x = (x & u(0x3333333333333333)) + ((x >> u(2)) & u(0x3333333333333333))
    x = (x + (x >> u(4))) & u(0x0F0F0F0F0F0F0F0F)
    return ((x * u(0x0101010101010101)) >> u(56)).sum(axis=-1, dtype=np.int64)


def _by_count(pairs):
    return sorted(pairs, key=lambda p: (-p[1], -p[0]))


class TopNOracle:
    """TopN over the host words of field top, computed from the words
    with numpy: per-(row, shard) counts and src scores, then the three
    lanes' semantics — the fused gated totals, the no-src cache reduce and
    the reference's two-phase per-shard heap walk (fragment.go top
    :1018-1150, executor.go :694-733)."""

    def __init__(self, host_top):
        self.top = host_top
        self.rows = sorted(host_top)
        self.cnt = {r: popcounts(w) for r, w in host_top.items()}  # int64[S]

    def scores(self, src):
        return {r: popcounts(w & src) for r, w in self.top.items()}, popcounts(src)

    def fused(self, src, n, thr=1, ids=None):
        sc, _ = self.scores(src)
        thr = max(thr, 1)
        cands = [r for r in ids if r in self.top] if ids else self.rows
        totals = {r: int(np.where((self.cnt[r] >= thr) & (sc[r] >= thr), sc[r], 0).sum())
                  for r in cands}
        pairs = _by_count((r, t) for r, t in totals.items() if t > 0)
        return pairs if ids or not n else pairs[:n]

    def cache_only(self, n, thr=1):
        thr = max(thr, 1)
        gated = {r: np.where(self.cnt[r] >= thr, self.cnt[r], 0) for r in self.rows}
        union = set()
        for s in range(len(self.cnt[self.rows[0]])):
            ranked = _by_count((r, int(gated[r][s])) for r in self.rows)
            union.update(r for r, c in ranked[:n] if c > 0)
        pairs = _by_count((r, int(gated[r].sum())) for r in union)
        return [p for p in pairs if p[1] > 0][:n]

    @staticmethod
    def _walk(pairs, score, n, thr, tanimoto, src_count):
        import heapq
        import math

        lo = src_count * tanimoto / 100.0 if tanimoto else 0.0
        hi = src_count * 100.0 / tanimoto if tanimoto else 0.0
        heap = []
        for r, c in pairs:
            if c <= 0 or (tanimoto and (c <= lo or c >= hi)) or (not tanimoto and c < thr):
                continue
            if n == 0 or len(heap) < n:
                k = score(r)
                if k == 0:
                    continue
                if tanimoto:
                    if math.ceil(k * 100 / (c + src_count - k)) <= tanimoto:
                        continue
                elif k < thr:
                    continue
                heapq.heappush(heap, (k, r))
                continue
            if heap[0][0] < thr or c < heap[0][0]:
                break
            k = score(r)
            if k >= heap[0][0]:
                heapq.heappush(heap, (k, r))
        return [(r, k) for k, r in heap]

    def two_phase(self, src, n, thr=1, tanimoto=0):
        sc, src_counts = self.scores(src)
        n_shards = len(src_counts)

        def merged(ids, n_walk):
            acc = {}
            for s in range(n_shards):
                if ids is None:
                    pairs = _by_count((r, int(self.cnt[r][s])) for r in self.rows)
                else:
                    pairs = [(r, int(self.cnt[r][s]) if r in self.cnt else 0) for r in ids]
                for r, k in self._walk(pairs, lambda r: int(sc[r][s]), n_walk, thr,
                                       tanimoto, int(src_counts[s])):
                    acc[r] = acc.get(r, 0) + k
            return acc

        phase1 = merged(None, n)
        if not phase1:
            return []
        pairs = _by_count(merged(sorted(phase1), 0).items())
        return pairs[:n] if n else pairs


def topn_main_path_queries(host):
    """(PQL, expected pairs) of the TopN main path."""
    f = host["f"]
    o = TopNOracle(host["top"])
    qs = [(f"TopN(top, Row(f={r}), n=5)", o.fused(f[r], 5)) for r in (10, 11, 16)]
    qs.append(("TopN(top, Intersect(Row(f=10), Row(f=11)), n=5)", o.fused(f[10] & f[11], 5)))
    thr = 131100  # near the median per-shard score (2^20 / 8): gates about half
    qs.append((f"TopN(top, Row(f=12), n=5, threshold={thr})", o.fused(f[12], 5, thr=thr)))
    ids = [1, 4, 9, 99]  # row 99 is absent
    qs.append((f"TopN(top, Row(f=13), ids={ids})", o.fused(f[13], 0, ids=ids)))
    qs.append(("TopN(top, n=5)", o.cache_only(5)))
    qs.append(("TopN(top, Row(f=14), n=5, tanimotoThreshold=15)",
               o.two_phase(f[14], 5, tanimoto=15)))
    return qs, o


def run_topn_main_path(device, holder, engine, ex, host):
    """TopN through Executor.execute with the engine (K3, K4), then one
    TopN through an engine-less Executor (Fragment.top per shard: P2).
    Each path's counters are zeroed just before it and read just after."""
    import torch

    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.parallel import kernels

    t0 = time.perf_counter()
    st = engine.field_stack("bench", "top", "standard")
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"main path: stack top {tuple(st.matrix.shape)} ({st.matrix.numel() * 4 / 1e9:.3f} GB) "
        f"built and uploaded in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    queries, o = topn_main_path_queries(host)
    log(f"main path: TopN numpy oracle in {time.perf_counter() - t0:.3f} s")
    kernels.score_rows_cuda.launches = 0
    kernels.topn_trim_cuda.launches = 0
    kernels.and_popcount_rows_cuda.launches = 0
    for q, want in queries:
        got = [tuple(p) for p in ex.execute("bench", q).results[0]]
        if got != want:
            raise AssertionError(f"{q}: port {got} != numpy oracle {want}")
        log(f"main path: {q} -> {got}")
    launches = {"score_rows": kernels.score_rows_cuda.launches,
                "topn_trim": kernels.topn_trim_cuda.launches}
    log(f"main path: {len(queries)} TopN queries exact against numpy; launches {launches}")
    if kernels.and_popcount_rows_cuda.launches:
        raise AssertionError("the engine's TopN lanes launched P2")

    # The engine-less executor: every shard's Fragment.top scores its
    # candidates with P2 (both phases of the reference's TopN).
    q = "TopN(top, Row(f=10), n=5)"
    want = o.two_phase(host["f"][10], 5)
    kernels.and_popcount_rows_cuda.launches = 0
    t0 = time.perf_counter()
    got = [tuple(p) for p in Executor(holder).execute("bench", q).results[0]]
    wall = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"{q} (no engine): port {got} != numpy oracle {want}")
    launches["and_popcount_rows"] = kernels.and_popcount_rows_cuda.launches
    log(f"main path: {q} without an engine over all {len(o.cnt[0])} shards -> {got}, "
        f"exact, in {wall:.3f} s (row mirrors built on first use); P2 launches "
        f"{launches['and_popcount_rows']}")
    return launches


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


def _entry(name, source, replaces, launches, err, ms, plain, byts, ops, library):
    """One {"kernels": [...]} entry; the bound is the larger of the bytes
    over the memory rate and the integer operations over the card's rate."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library,
    }


def time_topn(engine, ex, holder, device, err, launches):
    """K3, K4 and P2 at the TopN main path's shapes (P2 also at
    scripts/pallas_vs_xla.py's), each held against its plain version
    there first, and the end-to-end TopN p50."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.ops import bitops
    from pilosa_tpu_torch.parallel import kernels

    sync = torch.cuda.synchronize
    canonical = engine.canonical_shards("bench")
    S, W = len(canonical), 32768
    stack = engine.field_stack("bench", "top", "standard")
    entry = engine._topn_candidates("bench", "top", stack)
    K = entry.cand_idx.shape[0]
    mask = engine._mask_words(canonical, canonical)
    lowered = []
    for r in range(10, 22):  # TopN(top, Row(f=r), n=5), as bench.py:547-555 rotates
        prog, lw = engine._lower_src("bench", pql.parse(f"Row(f={r})").calls[0], canonical)
        lowered.append((prog, kernels.compile_prog(prog), lw.mats))
    for prog, code, mats in lowered[:2]:  # held against plain at this shape
        _, _, got = kernels.score_rows_cuda(code, mats, mask, stack.matrix, entry.cand_idx,
                                            scores=False, cnt=entry.dev_cnt, thr=1)
        want = kernels.topn_full_tree_plain(prog, mats, mask, stack.matrix, entry.cand_idx,
                                            entry.dev_cnt, 1, None)
        err["score_rows"] = max(err["score_rows"], _exact("K3", got, want, "at the main-path shape"))
    it = iter(range(10 ** 9))

    def k3():
        _, code, mats = lowered[next(it) % len(lowered)]
        return kernels.score_rows_cuda(code, mats, mask, stack.matrix, entry.cand_idx,
                                       scores=False, cnt=entry.dev_cnt, thr=1)[2]

    def k3_plain():
        prog, _, mats = lowered[next(it) % len(lowered)]
        return kernels.topn_full_tree_plain(prog, mats, mask, stack.matrix, entry.cand_idx,
                                            entry.dev_cnt, 1, None)

    for _ in range(3):
        k3()
    sync()
    ms3 = p50_ms(k3, 15, sync)
    plain3 = p50_ms(k3_plain, 3, sync, batch=1)
    # Least work: each candidate row and the src row of every requested
    # shard read once, the counts, mask and indices read, the totals
    # written; an AND, a popcount and an add per candidate word.
    bytes3 = (K + 1) * S * W * 4 + K * S * 4 + S * 4 + K * 4 + K * 8
    out = [_entry("score_rows", "pilosa_tpu_torch/csrc/score_rows.cu",
                  "pilosa_tpu/parallel/kernels.py:346", launches["score_rows"],
                  err["score_rows"], ms3, plain3, bytes3, 3 * K * S * W, None)]
    log(f"times: K3 score_rows p50 {ms3:.4f} ms at K={K}, S={S} "
        f"(bound {out[-1]['bound_ms']:.4f} ms, plain {plain3:.3f} ms)")

    totals = k3()
    n_out = 5
    got = kernels.topn_trim_cuda(totals, n_out)
    want = kernels.topn_trim_plain(totals, n_out)
    err["topn_trim"] = max(err["topn_trim"], _exact("K4", got[0], want[0], "vals at the main-path shape"),
                           _exact("K4", got[1], want[1], "idx at the main-path shape"))
    ms4 = p50_ms(lambda: kernels.topn_trim_cuda(totals, n_out), 15, sync)
    plain4 = p50_ms(lambda: kernels.topn_trim_plain(totals, n_out), 5, sync)
    # The one PyTorch call with the same order: a stable descending sort
    # (its first n_out entries); timed as a yardstick, never used.
    lib4 = p50_ms(lambda: torch.sort(totals, descending=True, stable=True), 15, sync)
    out.append(_entry("topn_trim", "pilosa_tpu_torch/csrc/topn_trim.cu",
                      "pilosa_tpu/parallel/kernels.py:382", launches["topn_trim"],
                      err["topn_trim"], ms4, plain4, K * 8 + n_out * 8, K * K, lib4))
    log(f"times: K4 topn_trim p50 {ms4:.4f} ms at K={K}, n_out={n_out} (bound "
        f"{out[-1]['bound_ms']:.6f} ms, plain {plain4:.4f} ms, torch.sort {lib4:.4f} ms)")

    # P2 at the main path's shape: one top fragment's mirror against the
    # src row's segment (what Fragment.top scores per shard), then at the
    # script's own shapes.
    frag = holder.fragment("bench", "top", "standard", 0)
    mat, _ = frag.device_matrix()
    row = holder.fragment("bench", "f", "standard", 0).device_row(10)
    shapes = [(mat, row)]
    prng = torch.Generator(device=device).manual_seed(2)
    for n_rows in (64, 512, 2048, 8192):
        m = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_rows, W), dtype=torch.int32,
                          device=device, generator=prng)
        shapes.append((m, m[n_rows // 2].clone()))
    p2 = []
    for m, r in shapes:
        e = _exact("P2", kernels.and_popcount_rows_cuda(m, r),
                   bitops.popcount_and_rows_plain(m, r), f"R={m.shape[0]}")
        err["and_popcount_rows"] = max(err["and_popcount_rows"], e)
        ms = p50_ms(lambda: kernels.and_popcount_rows_cuda(m, r), 15, sync)
        plain = p50_ms(lambda: bitops.popcount_and_rows_plain(m, r), 5, sync, batch=2)
        R = m.shape[0]
        bound = max((R * W * 4 + W * 4 + R * 4) / HBM_BYTES_PER_S, 3 * R * W / INT_OPS_PER_S) * 1e3
        p2.append((R, ms, plain, bound))
        log(f"times: P2 and_popcount_rows p50 {ms:.4f} ms at [{R}, {W}] "
            f"(bound {bound:.4f} ms, plain {plain:.3f} ms)")
    R, ms, plain, _ = p2[0]
    out.append(_entry("and_popcount_rows", "pilosa_tpu_torch/csrc/score_rows.cu",
                      "scripts/pallas_vs_xla.py:56", launches["and_popcount_rows"],
                      err["and_popcount_rows"], ms, plain, R * W * 4 + W * 4 + R * 4,
                      3 * R * W, None))

    # End to end: Executor.execute of TopN(top, Row(f=r), n=5) over the 12
    # src rows, host clock around a synchronous answer.
    qs = [f"TopN(top, Row(f={r}), n=5)" for r in range(10, 22)]
    lat = []
    for _ in range(3):
        for q in qs:
            t0 = time.perf_counter()
            ex.execute("bench", q)
            lat.append((time.perf_counter() - t0) * 1e3)
    log(f"times: end-to-end TopN(top, Row(f=r), n=5) p50 {statistics.median(lat):.4f} ms "
        f"over {len(lat)} queries")
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
    err.update(check_topn_kernels(device, args.seed))
    holder, engine, ex, host, launches = run_main_path(device, N_SHARDS, args.seed)
    launches.update(run_topn_main_path(device, holder, engine, ex, host))
    for v in launches.values():
        if v <= 0:
            raise AssertionError(f"a kernel of the main path never launched: {launches}")
    kern = time_kernels(engine, ex, device, err, launches)
    kern += time_topn(engine, ex, holder, device, err, launches)
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
