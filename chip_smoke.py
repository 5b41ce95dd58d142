#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (pilosa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--check-only | --root DIR [--serving ORDER] | --sass DIR]

Phases, each of which fails the run (non-zero exit) when it fails:

1. build — nvcc compiles every kernel source under pilosa_tpu_torch/csrc/
   (one nvcc per source, all started together) into build/torch_kernels/.
2. kernels — K1 count_tree_dense and K2 count_tree_blocks, K3 score_rows
   (with TopN's trim in the last block of its full-TopN launch) and P2
   and_popcount_rows against their plain PyTorch
   versions on the card: random and adversarial words (all-ones,
   sign-bit-only, zero), masked shards; for K2 block words of every
   density, block 63 (the sign bit), all 64 bits, one bit, ragged shard
   counts, chain and interpreter trees, launches overlapping on two
   streams; for K3 K in {1, 8, 16, 128, 129, 1000,
   4096}, pad and absent slots, zero and multi-leaf src trees, split
   (clustered) launches; for its trim ties, all-zero totals, n_out in
   {1, 5, K} and none (the totals copied out), and launches overlapping
   on two streams, then the trim alone on totals set in its scratch
   (TrimOnCard) at K in {1, 8, 16, 128, 129, 257, 1000, 2048, 4096},
   n_out in {1, 5, 64, 255, 256, 257, K} and none, totals drawn, tied,
   all equal, zero and at 2^31 - 1, and on two streams; for P2 R in {1, 8, 16, 17, 64, 129, 8192}, every
   row or rows by index (a subset, a permutation, one row, a list past
   the launch-parameter cap); for K5 count_batch_tree K in {1, 2, 8, 9,
   64, 65, 256, 512} random chain and interpreter trees with zero leaves,
   duplicates fanned out, masks of no shard, every shard, one shard and a
   ragged set, leaves of two stacks, 128 and 1024 distinct leaf rows, 37
   shards (two mask words), no shards, launches overlapping on two
   streams; for the range leaf (in K1, K2 and K3), K6 sum_tree and K7
   minmax_tree depths 0, 1, 8, 31, 32 and 63, every condition and
   BETWEEN, predicates 0, 2^31, 2^63 - 1 and drawn ones, adversarial
   planes, missing planes, one to four range leaves (five refused),
   filters with and without range leaves, 12 and 31 shards, masks, K2's
   block words, two streams; for K8 groupn_tree 1 to 8 fields, K of 1,
   2, 3, 4, 32 and 33 (up to 1024 combinations, 1025 refused), the
   register form's shapes (C up to 32, fields reordered) and the walk's
   (up to 32 rows staged), rows repeated and missing (-1), no filter, a chain, an interpreter
   tree and one to four range leaves, masks of no shard, every shard and
   a ragged set, 12 and 37 shards, two streams; for F1 fused_tree random flat
   slot tables of 1 to 16 slots (mref chains, repeated and xor-cancelling
   references, zeros, one to four range leaves), up to 32 count edges with
   per-edge gates, materialized slots with and without a need gate, 12 and
   37 shards, two streams, whole drains (F1 then K6, K7, K3 and K8 on its
   slots) against fused_tree_plain, 17 slots and 33 edges refused; for the
   pool leaf (rowb) in K1, K2, K3, K5, K6, K7, K8 and F1, and K1P
   count_tree_pool, K3P score_rows_pool (scores, src counts, gated totals
   and the trim, K = 8 and 300), K6P sum_tree_pool (full and holed
   planes), K5P count_batch_tree_pool (K = 1, 9, 65, 301 staged, 8 and
   300 over more than 128 distinct rows, the direct path; a fan-out) and
   F1P fused_tree_pool (counts, its pool and table against
   fused_mat_pool_plain block for block, with and without a need subset
   that leaves out shard 0; whole drains with every edge kind over its
   pool rows, K3P's trim at K = 300) against both their pool plain
   versions and the whole-row ones: random slot layouts with slot-0
   blocks, rows all zero, slots shared by two rows, a pool of one slot,
   pool leaves alone and beside stack rows and range leaves, mref chains,
   trees and slots whose live word is 0 and whose live word is full, 12
   and 37 shards, two streams; K5 with range leaves (check_batch_ranges:
   every kind at depths 1 to 63, 1, 8, 12 and 16 conditions on one field,
   two fields, the staged tiles and the direct path); K7P alone
   (check_minmax_pool: Min and Max at depths 1, 8 and 63, live words of
   0, 1 and 64 blocks, empty and unrequested shards, ties across shards);
   K10 eval_tree (check_eval_tree: every word of the main path's trees,
   range leaves of every kind, pool leaves, masks of every, no and half
   the shards, 31 shards); K3's trim launched alone (check_trim_alone:
   check_trim's totals, the caller's totals kept, two streams).
   Integer results, so they must agree exactly.  --check-only stops here.
   native — host only: each path of pilosa_tpu_torch/native (ingest
   through Field.import_bulk, a fragment's load, codec.serialize) timed
   against its numpy twin in turns, their results equal (run_native_ab).
3. main path — the north-star index of bench.py at full scale: index
   "bench" of 960 shards (~1.007B columns), field f of 24 dense random rows,
   field s of 24 rows that each occupy 4 of the 64 occupancy blocks of
   every shard, and field top of 16 rows rand & rand (bench.py:434-438).
   Count: Executor.execute answers Count(Intersect(...)) for the 12
   disjoint row pairs of f and s plus one Union/Difference/Xor tree each;
   f must take the dense path (K1) and s the sparse path (K2).  TopN:
   TopN(top, <src>, n=5) for several src rows and an Intersect, a
   threshold= query, an ids= query, a no-src query and a Tanimoto query
   (the two-phase lane), through the engine (K3), then one TopN through
   an engine-less Executor (Fragment.top per shard: P2).  Then the wide
   part: index wide of 16 shards, field src of 8 dense rows and field w
   of 4096 rows repeating 512 base rows of rand & rand & rand (8.6 GB on
   the card), and five TopNs over all 4096 candidates (n = 5, 100, 4096,
   an Intersect src, a threshold), each one K3 call that trims the 4096
   totals (score_rows_trim_kernel after K3), no P2 launch and no host
   fallback; K3's time
   at that shape and what the trim adds to it (n_out 5 and 4096).  Every answer
   equals a numpy oracle over the host words, and each path's kernels'
   launch counters, zeroed just before it, must have moved.  Then the
   engine-less TopN again, warm (its wall time); after phase 4, once more
   under torch.profiler, whose kernel list must hold P2 alone, and one
   warm engine TopN, whose list must hold K3 and one copy back alone.
4. times — each kernel at the main path's shapes (the trim: what it
   adds to a K3 call, at K = 16, 1000 and 4096 with n_out 5 and K,
   beside torch.sort of the same totals): "ms" (CUDA events
   around 10 calls of the Python wrapper, the oldest column, kept for
   comparison: for a kernel whose device work is microseconds, that is
   the host's enqueue rate), "device_ms" (torch.profiler's kernel time
   per launch; the run fails where the profiler sees no kernel),
   "host_us" (host microseconds per wrapper call, no synchronise in the
   window), beside
   its bound, its plain version's p50 (and a library call's where one
   computes the same function); P2 also at scripts/pallas_vs_xla.py's
   shapes; the end-to-end Count and TopN p50s, and the card's name and
   power limit; K5 at K = 8, 64 and 256 distinct two-row trees on f,
   beside the device time of as many K1 launches; K10 eval_tree on
   Intersect(Row(f=10), Row(f=22)) over 960 shards (one process) and 480
   (a rank's block), beside torch.bitwise_and of the same rows; K3's trim
   alone at K = 16 and 4096, beside torch.topk.
   serve — batched Count serving on the same index, before phase 5: a
   query of 8 consecutive Counts on f, and one on s, each one K5 launch
   and no K1/K2 launch; 64 threads x 32 Executor.execute_async Counts
   (the 30 trees of phase 3) with the result memo off, every answer
   against numpy, printing queries/s, p50 latency, batches, batched
   queries and the mean batch (>= 2), the K5 counter moved and no
   _QueryFuture fallback; the same stream from the memo, with no launch
   at all; the serial Count and 8-Count p50s; then bench.py's config-2
   index b10m (10 shards, 128 dense rows): its 32 four-row trees against
   numpy, setops_tree_10M_cols_p50 and setops_tree_single_dispatch_p50,
   and K5 at K = 32 there.
   bsi — after serve, before phase 5: bench.py's BSI field v (depth 8)
   and time field t (YMD) on the same index; Sum/Min/Max, Count(Range)
   for every condition on all shards and a subset, the time-range Counts
   and a 4-Count query with Ranges (K5 declines those to K1) against a
   numpy value histogram, the range-leaf, K6, K7, K1 and K5 counters
   moved and no host-lane fallback; each kernel at the main path's
   shape against its plain version and its bound; bench.py's
   sum/min/max_bsi_1B_cols_p50, their _e2e_p50 and timerange_1B_cols_p50;
   then one Set(col, v=N) and an import_values of 2^20 values, each
   followed by Sum/Min/Max, the stack synced in place.
   groupby — after bsi, before phase 5: bench.py's config-5 fields ga,
   gb and gc (4, 2 and 2 rows of rand & rand over all 960 shards); the
   8-way and 3-field GroupBy through Executor.execute, with
   filter=Row(f=10), with filter=Range(v > 100) (a range leaf in K8),
   with limit/offset and on a shard subset (the fused lane: K8's counter
   must move, with no host fallback), one with a child Rows(limit=) and
   one with previous= (the host lane), and Rows with column=, limit= and
   previous=, each against a numpy oracle, and GroupBy over ga, gb and
   top (4 x 2 x 16: K8's walk); K8 at the 8-way, 3-field and filtered
   shapes (the register form) and the 4 x 2 x 16 one against its plain
   version and its bound (a device time below the bound is taken again,
   at most three times); bench.py's
   groupby_8way/3field_1B_cols_p50 and _e2e_p50; the trim's torch.sort
   yardstick is timed at K = 16, 1000 and 4096 in phase 4.
   api — after groupby, before phase 5: only pilosa_tpu_torch.api.API.
   Field fk on bench (24 dense random rows keyed "k00".."k23", filled
   like f): keyed Count(Intersect/Union/Difference) (K1), one with s
   (K2), a query of 8 keyed Counts (one K5), TopN(fk, Row(f=10), n=5)
   with its row keys (K3), Options(Count(...), shards=<480 of 960>) and
   Options(Row(fk=...), excludeColumns=true); index users of 2^20 column
   keys imported through API.import_bits in batches of row keys x column
   keys (field seg, 8 keyed rows), SetColumnAttrs on 1,000 columns, a
   keyed Row(seg=...) (its columns as keys) and columnAttrs, and a keyed
   import into seg's resident stack, synced in place; SetRowAttrs on
   top's 16 rows and TopN(top, Row(f=11), n=5, attrName=..., attrValues=
   [1, 2]) (two K3 launches, the host walk filters); API.import_roaring
   of 2^20 bits into one shard of fk, synced in place (stack_updates +1,
   stack_rebuilds +0). Each answer against numpy; the K1, K2, K5 and K3
   counters, zeroed just before the phase, must have moved, P2's not;
   the p50 of API.query beside Executor.execute per operation, and the
   import seconds.
   fusion — after api, before phase 5: indexes dash and dash2 (bench.py's
   dashboard at 960 shards, seed 23: seg 4 rows rand | rand, w rows 1-4
   rand, g 4 rows rand, v an int field 0..100 on 30,000 columns per 8
   shards); the widgets at N = 2, 4, 8, 10 through TorchEngine.fused_many
   (F1 once per drain, then K6, K7, K3, K8 on its slots) and one by one
   through solo_op, through Executor.execute from N threads at once (the
   aggregates pool in one batcher drain) and bench.py's cross-index drain
   (one F1 per index), every answer against numpy with the memo off; F1's
   launches zeroed just before and counted, fused_programs moving in the
   executor's part and F1 in its profiler window; one Set into seg, after
   which the 10-widget plan rebuilds (the stack synced in place) and stays
   exact; bench.py's dashboard_fused_qps, dashboard_p50_ms,
   dashboard_fused_speedup and dashboard_crossindex_p50_ms, and F1 at the
   10-widget shape against its plain version and its bound.
   http — after fusion, before phase 5: pilosa_tpu_torch.net.server.serve
   over the same holder and engine on the default (async reactor)
   backend, as bench.py:806-824 serves them, with bench.py's v10 added to
   b10m.  Over HTTP, the launch counters zeroed first: Count(Intersect) on
   f (K1) and s (K2), the 8-Count query (K5), TopN(top, Row(f=10), n=5)
   (K3), Sum(field=v10) (K6), GroupBy(ga, gb) (K8), a protobuf query and a
   protobuf import, and an import-roaring into f synced in place
   (stack_updates +1, stack_rebuilds +0); every answer against numpy and
   each of those counters moved.  Then bench.py's loops with the memo
   off, every reply 200 and checked: http_count_e2e_p50 (30 sequential
   urllib requests of the c2 texts), http_count_qps (one client process,
   640 connections x 32, after the warm of tiers 1, 9, 65 and 257; the
   batcher's batches, mean batch and K5's launches by K, those at
   K >= 256 among them) and http_mixed_qps (Count, Count, TopN, Sum; F1's
   launches counted); after those timed loops, POST /recalculate-caches,
   a /debug/pprof/trace whose Chrome trace must name the Count kernels,
   /debug/pprof/profile and /heap, and /debug/vars' engineCaches;
   continuous queries with the memo on, over index cqi
   of their own (10 shards): POST /cq of a Count tree, a Set over HTTP,
   then GET /cq/{id}?since=1&wait_ms=5000 returns the new count, equal to
   a fresh query and served by the repair layer (resultRepair in
   /debug/vars moved), a Row subscription's one-id diff after a one-bit
   Set, and 404 after DELETE; the same p50 on the threaded backend; and
   the node through its entry point: python -m pilosa_tpu_torch server on a data
   directory under build/http_node, b10m's 128 rows on 2 shards by
   import-roaring through InternalClient, the c2 Counts, the CLI's export
   and backup of a small index, SIGTERM, a restart whose warm start must
   build every stack and skip none before /readyz answers 200, and the
   Counts again; /metrics carries pilosa_server_requests_total, and the
   node must exit 0 with no traceback.
   procmode — after http, before residency: process mode and the query
   plans over the same API, bench and b10m, the memo off.  bench.py's
   workers sweep (serve(api, workers=w) for w in 0, 1, 2, 4, 8; 128
   connections x 64 c2 Counts, every reply 200 and exact):
   http_count_qps_w{w}, the batch occupancy, cross_worker_fused_batches
   (> 0 at w >= 2), the worker processes' boot to HELLO and w2/w0; with 4
   workers nvidia-smi's compute apps are those of the owner alone, with no
   worker pid, and no worker has a /dev/nvidia* node open while the owner
   has; with 2, POST /cq, GET and DELETE over cqi, a /cq request that a
   worker took reaching the owner as a passthrough frame, and Counts
   answered while a long-poll waits, whose delta after a Set is exact; a
   sparse
   Count with ?profile=1 and X-Pilosa-Tenant answered by a worker: exact,
   its plan path sparse with the engine's own block counts, K2 in the
   profiler's window, the plan under its trace id in /debug/plans, and
   /debug/sequences answering; Explain(Count(...)) returns the plan with
   no kernel in the profiler's window and no launch counted; bench.py's
   profile_overhead_pct estimator (bench.py:3097-3212) on an 8-shard
   index; then python -m pilosa_tpu_torch server with [server] workers =
   2 on the http phase's data directory (restart to ready), a SIGKILL of
   one worker (/readyz 503, then 200 after the respawn) and the c2 Counts
   exact before and after.
   residency — after http, before phase 5, on its own holder and engines
   (freed after): bench.py's residency sweep at 960 shards (index rsw:
   wf0..wf3 of 32 rows, each rand & rand in 8 of the 64 occupancy blocks
   of every shard, 16.1 GB dense; rt, 4 rows; rv, an int field), an
   engine with twice the index as its budget (the fully resident
   yardstick, freed before the next part) and one with a quarter of it
   less one row-shard (no stack fits).  A cold dashboard (one
   Count(Intersect) per field) from the host lane, fallbacks and
   promotion requests counted; the same dashboard warm from the block
   pools (one K1P launch each, no fallback); an 8-Count query on pool rows
   (one K5P launch), a fused drain with Counts, a Sum and a TopN filtered
   by pool rows (each warm drain one F1P launch, then one K6P and one K3P
   edge over its slots as pool rows), TopN and Sum through the executor,
   each with its p50 (the drain's through fused_many); an uncovered row
   growing the working set; Sets into empty blocks, a Clear and an import
   synced in place into the pool (a freed slot reused, slot 0 zero);
   working sets rotated in until the budget evicts and the cached fused
   plan is dropped.  Every answer against numpy.  Prints bench.py's
   oversubscribed_4x_count_p50_ms, fully_resident_count_p50_ms,
   oversubscribed_4x_cold_p50_ms, residency_hit_rate and
   promotion_overlap_mbits_s, K1P's time (rowb_k1p) against its bound
   beside the K1 it replaced, the device time of K3P and K6P on those
   calls against their live bytes and every kernel of one drain against
   the drain's (pool_leaf_in), K3P and K6P through their wrappers
   (pool_aggregates: exact against numpy and both plain versions, their
   times against the bytes of the live blocks beside the whole-row walk
   of K3 and K6 over the same rows, and both again over a full live
   word), K5P and F1P through theirs with the engine's arguments
   (pool_batch_and_drain: exact, their times beside K5's and F1's
   whole-row walks over the same arguments), and the engine's default
   budget.  Its holder stays open for the observe phase.
   observe — after residency, before phase 5: bench.py's promote-ahead
   A/B at equal budget (bench.py:2333-2392) on rsw (wf1 and wf3
   alternating, a residency flush as the gap, 12 cycles, 2 learning; the
   budget 1.5 × one 64-slot pool of 960 shards), advisor off and on:
   residency_advisor_ab_speedup, each arm's p50, host fallbacks,
   promotions by cause and K1P launches, every answer against numpy and
   advisor promotions in the on-arm; bench.py's advisor sweep
   (bench.py:3225-3331): prefetch_advisor_hit_rate (at least 0.7),
   heat_observe_us, heat_overhead_pct; bench.py's history section
   (bench.py:3380-3460, a synthetic clock): history_tick_us,
   history_sampler_overhead_pct, history_query_p50_ms, and the PQL Sum
   over _system through Executor.execute, equal to the sampler's points,
   on K6 with no host fallback; then python -m pilosa_tpu_torch server
   with two workers, history, an SLO and statsd: the heat recipe (rows
   0/1/8/9 ranked, a residency gap seen, the advice, the gauges and
   counters, the gap in the history), a serve-side error rule until
   slo.burn (/readyz degraded, a flight-recorder bundle persisted), the
   rule healed until slo.clear, the OpenMetrics exemplars and # EOF, and
   the statsd datagrams.  Every kernel count (KERNEL_COUNTERS) is set to
   0 before the phase and read after it (observe_launches: this process's
   launches; the node's own launches are in its device owner's process and
   not counted); K1P and K6 must have launched.
   repair — after observe, before phase 5: bench.py's repair sweep
   (bench.py:1891-2090, seed 16) on a holder of its own at 960 shards
   (bench.py: 8), freed at the end: index rpw with seg (16 rows, 4000
   bits a shard), g1 (6 rows) and g2 (5) of 800, v an int 0..1023 with
   600 values; the dashboard Count(Intersect(seg=1, seg=2)),
   Count(Union(seg=3, 4, 5)), TopN(seg, n=8), GroupBy(g1, g2),
   Sum(field=v) 24 times idle, then 12 write rounds (64 bits into each of
   2 seg shards, one Set in g1 or g2, one of v, every third round an
   OPAQUE load_row_words of seg row 0) with 5 timed serves each, every
   round's served answers equal to a recompute with the repair layer
   suspended and the memo cleared.  In each round with no OPAQUE write
   the serve that repairs launches nothing, and the recompute launches
   K1, K6 and K8; repairs > 0 and fallbacks >= the OPAQUE rounds.
   bench.py's result_memo_hit_rate_under_write_load (at least 0.9),
   dashboard_p50_under_ingest_vs_idle, repair_touched_words_per_repair
   and dashboard_repair_serve_p50_ms, with the recompute's p50; every
   kernel count set to 0 before the phase and read after it
   (repair_launches).
   cluster — after repair, before phase 5: three node processes (python
   -m pilosa_tpu_torch server) on the one card, [cluster] replicas = 2,
   node 0 the coordinator, nodes 1 and 2 with [gossip] seeds at node 0's
   gossip port on loopback.  Each node's data directory is written before
   it starts, with the port's Holder, from the main path's own words (f,
   24 rows; top, 16 rows): only the shards the port's placement gives it
   (about 640 of the 960, 3.3 GB), its id and the three-node topology.
   K9 topn_slab first at the phase's shape in this process (the main
   engine's top stack, node 0's shards masked), exact against its plain
   version and timed.  Then Count(Intersect(Row(f=a), Row(f=b))) and
   TopN(top, Row(f=a), n=5) through every node's HTTP, equal to numpy
   (the TopN to the reference's two-phase walk over the words); each
   node's /debug/vars must show K1 and K9 launches and the slab lane
   served with no decline.  A Set through the node that owns no replica
   of its shard, read back from both owners; the coordinator's
   cluster_count_p50_ms and cluster_topn_p50_ms beside the same queries'
   single-node HTTP p50s (an in-process node over the main engine); then
   node 2 killed and the same queries through nodes 0 and 1 again, the
   reads failing over to the surviving replicas.  The data directories
   are removed at the end.
   mesh — after cluster, before phase 5: two ranks of one multi-process
   mesh on the one card (python -m pilosa_tpu_torch server -c
   mesh_n{i}.toml: [mesh] coordinator on loopback, processes = 2,
   process-id = i, the other node as its peer, node 0 the sequencer), each
   holding 480 of the 960 canonical positions, its collectives on gloo
   over host copies.  Both data directories hold index bench with f, top,
   v, ga and gb at every shard, written from the main holder's rows while
   the cluster phase's nodes open theirs: f and top are hard links to the
   cluster phase's files, v, ga and gb serialized once and the second
   directory's files hard links to the first's.  Each query kind once
   through node 0, exact against numpy, with the psum-dispatch count
   moving on both nodes: Count(Intersect), a two-Count query, Sum, Min and
   Max of v, TopN(top, Row(f=10), n=5), GroupBy(Rows(ga), Rows(gb)) and a
   Row tree restricted by Options(..., shards=[...]) to two shards on
   each rank; then both nodes initiating every query at once under
   tickets, every answer exact; the coordinator's HTTP p50 of Count and
   TopN beside the cluster phase's and one node's; each node's device
   bytes, gloo all-gather and all-reduce times, no host fallback and no
   failed broadcast, and K1, K5, K6, K7, K3, its trim alone, K8 and K10
   launched on both.
5. write — on the same index, last because it writes it: 32 Sets and 32
   Clears through Executor.execute on f=10 (dense) and s=10 (sparse;
   half its Sets into blocks the row left empty), each read back by a
   Count(Intersect) against a numpy oracle kept beside it, with
   write->Count p50 and the scatter's host time; one Set and Count under
   torch.profiler, whose list must hold the scatter; a bulk import of
   2^20 bits into f synced by the IngestSyncer (its seconds), then every
   f Count against the oracle; writes to top, then an engine TopN against
   the oracle.  Each single-bit write is also read back through
   execute_async, and 24 Sets on f=12 run beside 16 threads streaming
   execute_async Counts: each Count submitted after a Set returned must
   see it.  Then ClearRow on rows f=33 and s=33 and a
   Store(Intersect(Row(f=100), Row(f=101)), f=227) on b10m, each read
   back by Counts against the oracle.  No stack is rebuilt through all of
   it and some are synced in place; then one write to a new row must
   rebuild f exactly once (its seconds, beside the bulk sync's).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs one card and fails without one.

--root DIR (A/B of two checkouts in one call, e.g. the parent commit
unpacked with git archive into an ignored directory, and "."): imports
pilosa_tpu_torch from DIR, builds phase 3's index with it and prints one
JSON line: the dense and sparse Count p50, the engine TopN p50, the warm
engine-less TopN wall time, Fragment.top's microseconds per call, and the
kernels that the sparse Counts and one warm engine-less TopN put on the
card with their device time per launch (torch.profiler), then phase 5's
write->Count p50 and bulk-sync seconds (a checkout without the in-place
sync pays a rebuild for each), and the p50 of one query of 8 consecutive
Counts on f with the kernels it puts on the card (8 K1 launches where
Counts run one by one, one K5 where the run is one count_many), and
(ab_kernels) K3's full TopN at K = 4096 copying its totals out and
trimming to 5 and 4096, and K8 at the 8-way, 3-field and filtered
shapes and at 32 x 32, device ms per launch; (ab_count_lanes) the lone
Count's p50 in one process with the executor's lane on engine.count and
on engine.batched_count in turns; (ab_http) the http phase's
http_count_e2e_p50, http_count_qps and http_mixed_qps loops through the
checkout's node on its own b10m; (ab_pool) K1P, the full
TopN against a pool row and the Sum under pool rows at the residency
sweep's shape through the checkout's wrappers (K3P and K6P where it has
them, the whole-row walks where not), and F1 over dense rows;
(ab_residency) the residency phase's index and engine, the drain's
fused_many p50 and the 8-Count query's Executor.execute p50 with every
kernel of one call of each (K5P, F1P, K6P and K3P where the checkout has
them, K5, F1, K6 and K3 where not); (ab_k1_kr) K1, KR and K6 at the bsi
phase's shape.  The
result memo is off for every timing loop.  The data,
queries and loops are this file's, so both trees are measured the same
way.  Run the trees in turns: parent, change, change, parent.

--root DIR --serving ORDER prints the serving numbers alone, for many
short calls in turns: the lone dense and sparse Count p50s and ab_http's
loops (640 connections x 16 c2 Counts, 640 x 8 mixed queries), one
round per entry of ORDER (on or off: the query-plan layer, where DIR has
one; -noheat after it: the heat feed off; -frozen: the http round under
gc.freeze), each round with the serving threads' CPU and the cyclic GC's
microseconds per query.

--sass DIR builds every kernel library of this checkout and of DIR (one
nvcc each, into build/sass/) and prints one JSON line: per library, how
many of DIR's functions compile to the same SASS here (cuobjdump -sass).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

N_SHARDS = 960  # 960 * 2^20 = ~1.007B columns (bench.py:66)
W64 = 16384  # uint64 words per 2^20-bit shard row
F_ROWS = range(10, 34)  # 24 rows -> 12 disjoint pairs (bench.py:66-75)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# 32-bit integer add and bitwise operations run at 64 a clock an SM, and
# population count at 16 (the CUDA C Programming Guide's arithmetic
# throughput table, compute capability 9.0): at an H100 SXM's 132 SMs and
# 1.98 GHz maximum SM clock, 1.67e13 and 4.18e12 a second.  card_rates()
# puts the card's own SM count and maximum clock in their place.
INT_OPS_PER_SM_CLOCK, POPC_PER_SM_CLOCK = 64, 16
INT_OPS_PER_S = INT_OPS_PER_SM_CLOCK * 132 * 1.98e9
POPC_PER_S = POPC_PER_SM_CLOCK * 132 * 1.98e9
BLOCKS_PER_ROW = 4  # occupied blocks of each sparse row, per shard
BLOCK_POOL = 8  # per shard, the sparse rows draw their blocks from 8
TOP_ROWS = range(16)  # field top: 16 TopN candidate rows (bench.py:70,434-438)
P2_CHECK_ROWS = (1, 8, 16, 17, 64, 129, 8192)  # every P2 grouping and cluster size


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


def card_rates():
    """Set INT_OPS_PER_S and POPC_PER_S from the card's SM count and its
    maximum SM clock (nvidia-smi clocks.max.sm); returns the two rates."""
    import torch

    global INT_OPS_PER_S, POPC_PER_S
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30, check=True)
        hz = float(res.stdout.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        hz = 1.98e9
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    INT_OPS_PER_S = INT_OPS_PER_SM_CLOCK * sms * hz
    POPC_PER_S = POPC_PER_SM_CLOCK * sms * hz
    return INT_OPS_PER_S, POPC_PER_S


def op_seconds(ops):
    """The least time of ``ops``: a count of 32-bit integer operations, or
    (integer operations, population counts), each at its own rate."""
    n_int, n_popc = ops if isinstance(ops, tuple) else (ops, 0)
    return max(n_int / INT_OPS_PER_S, n_popc / POPC_PER_S)


def least_ms(byts, ops):
    """A kernel's bound: the larger of its bytes over the memory rate and
    its operations over the card's rates (op_seconds), in ms."""
    return max(byts / HBM_BYTES_PER_S, op_seconds(ops)) * 1e3


def on_card(fn, expect=None, windows=3):
    """What ``fn()`` ran on the card, from torch.profiler (its CUDA kernel
    and copy times, key_averages): {name: [launches, device ms in all]},
    a kernel's name cut before its argument list.  Raises when the
    profiler saw no kernel, so that no check or time built on it can pass
    empty.

    The profiler on the card's machine loses device records now and then:
    a window's first ones (a scatter's copies and kernel, while the CPU
    side of the same trace showed them launched; 12 of 192 K1 launches),
    or all of a short window's.  So each window follows a throwaway
    session, and where ``expect(seen)`` is false ``fn`` runs again in a
    new window, ``windows`` times at most: a loss does not repeat, a
    fault does.  The last window is returned."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.zeros(1024, device="cuda")
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]):
            for _ in range(8):
                scratch.add_(1)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key).split("(")[0].strip()
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            acc = seen.setdefault(name, [0, 0.0])
            acc[0] += e.count
            acc[1] += us / 1e3
        full = any(not k.startswith(("Memcpy", "Memset")) for k in seen)
        if full and (expect is None or expect(seen)):
            break
    if not full:
        raise AssertionError(f"torch.profiler saw no kernel on the card: {seen}")
    return seen


def per_launch(seen):
    """{name: {"launches": n, "device_ms": per launch}} of on_card's table."""
    return {k: {"launches": n, "device_ms": t / n} for k, (n, t) in sorted(seen.items())}


def device_ms(fn, kernel, windows=5, batch=10, per_call=False, bound_ms=None):
    """Device time per launch of the kernels whose names contain
    ``kernel``, over ``windows`` runs of ``batch`` calls of ``fn`` back to
    back, from on_card; with ``per_call``, per call of ``fn``, each such
    kernel launching once per call: the sum of their per-launch times (so
    a window that lost some records does not read low).  Raises when the
    profiler saw no such launch.  With ``bound_ms``, a reading below the
    bound (records the profiler lost) is taken again, and raises the
    third time."""
    for attempt in range(3):
        seen = on_card(lambda: [fn() for _ in range(windows * batch)],
                       lambda seen: any(kernel in k for k in seen))
        hits = [v for k, v in seen.items() if kernel in k]
        launches, total = sum(n for n, _ in hits), sum(t for _, t in hits)
        if not launches or total <= 0:
            raise AssertionError(f"torch.profiler saw no {kernel} launch: {seen}")
        ms = sum(t / n for n, t in hits if n) if per_call else total / launches
        if bound_ms is None or ms >= bound_ms:
            return ms
        log(f"times: {kernel} read {ms:.4f} ms, below its bound {bound_ms:.4f} ms "
            f"(attempt {attempt + 1} of 3): the profiler lost records")
    raise AssertionError(f"{kernel}: device time below its bound in three windows")


def host_us(fn, sync, reps=15, batch=10):
    """Host microseconds per call of ``fn``: the host clock around
    ``batch`` calls with no synchronise inside the window; the p50 over
    ``reps`` windows."""
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        times.append((time.perf_counter() - t0) / batch * 1e6)
    sync()
    return statistics.median(times)


def measured(fn, kernel, sync, reps=15, per_call=False, bound_ms=None):
    """{"ms", "device_ms", "host_us"} of one kernel wrapper call: ``ms``
    as p50_ms has always measured it (CUDA events around 10 calls of the
    Python wrapper, so host-bound where the device work is microseconds),
    ``device_ms`` from the profiler (per_call, bound_ms: see device_ms),
    ``host_us`` from the host clock.  The ``ms`` window runs first, before
    any profiler session."""
    ms = p50_ms(fn, reps, sync)
    return {"ms": ms, "device_ms": device_ms(fn, kernel, per_call=per_call, bound_ms=bound_ms),
            "host_us": host_us(fn, sync)}


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


def _block_word_cases(rng, S):
    """(name, uint64[S] K2 block words) edge cases: random densities with
    ragged per-shard counts and masked (0) shards, block 63 (the sign
    bit) alone, all 64 bits, one bit per shard."""
    cases = []
    for most in (1, 2, 4, 8, 16, 32, 48, 64):
        words = np.zeros(S, np.uint64)
        for s in range(S):
            for b in rng.choice(64, int(rng.integers(0, most + 1)), replace=False):
                words[s] |= np.uint64(1) << np.uint64(b)
        if most == 64:
            words[0] = np.uint64((1 << 64) - 1)
        words[1] = 0  # an unrequested shard
        words[rng.random(S) < 0.25] = 0
        cases.append((f"ragged up to {most} blocks", words))
    cases.append(("bit 63", np.full(S, 1 << 63, np.uint64)))
    cases.append(("all 64 bits", np.full(S, (1 << 64) - 1, np.uint64)))
    cases.append(("one bit", np.uint64(1) << rng.integers(0, 64, S).astype(np.uint64)))
    return cases


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
        for what, bits in _block_word_cases(rng, S):
            bb = torch.from_numpy(bits.view(np.int64)).to(device)
            got = sparse.count_tree_blocks_cuda(code, mats, bb)
            torch.cuda.synchronize()
            want = sparse.count_tree_blocks_plain(prog, mats, bb)
            e = abs(int(got) - int(want))
            err["count_tree_blocks"] = max(err["count_tree_blocks"], e)
            if e:
                raise AssertionError(f"K2 {prog} {what}: {int(got)} != {int(want)}")
            n += 1
    # The dense and sparse forms agree when every block is marked, over a
    # ragged shard count too (31: seven CTAs of four shards and one of three).
    for S2 in (S, 31):
        mats2 = mats if S2 == S else [_adversarial_stack(rng, 4, S2, device) for _ in range(2)]
        every = torch.full((S2,), -1, dtype=torch.int64, device=device)
        for prog in KERNEL_PROGS:
            code = kernels.compile_prog(prog)
            a = int(kernels.count_tree_dense(code, mats2, torch.ones(S2, dtype=torch.int32, device=device)))
            b = int(sparse.count_tree_blocks_cuda(code, mats2, every))
            torch.cuda.synchronize()
            if a != b:
                raise AssertionError(f"K1 {a} != K2 over all blocks {b} for {prog} (S={S2})")
            n += 1
    # More shards than the grid holds at once (2048 threads per SM, 128 per
    # shard, on 132 SMs: 2112): the CTAs stride over the shards.
    S3 = 2200
    gen = torch.Generator(device=device).manual_seed(seed)
    mats3 = [torch.randint(-2 ** 31, 2 ** 31 - 1, (4, S3, 32768), dtype=torch.int32, device=device,
                           generator=gen) for _ in range(2)]
    for prog in (KERNEL_PROGS[0], KERNEL_PROGS[2], KERNEL_PROGS[6]):
        code = kernels.compile_prog(prog)
        for what, bits in _block_word_cases(rng, S3):
            bb = torch.from_numpy(bits.view(np.int64)).to(device)
            got = int(sparse.count_tree_blocks_cuda(code, mats3, bb))
            want = int(sparse.count_tree_blocks_plain(prog, mats3, bb))
            if got != want:
                raise AssertionError(f"K2 over {S3} shards {prog} {what}: {got} != {want}")
            n += 1
    del mats3
    # Two streams at once: each takes its own scratch word, so K2 launches
    # that overlap on two streams still finish exactly.
    side = torch.cuda.Stream(device=device)
    code = kernels.compile_prog(KERNEL_PROGS[0])
    words = [torch.from_numpy(b.view(np.int64)).to(device) for _, b in _block_word_cases(rng, S)]
    torch.cuda.synchronize()
    got = []
    for i in range(4 * len(words)):
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            got.append((words[i % len(words)], sparse.count_tree_blocks_cuda(code, mats, words[i % len(words)])))
    torch.cuda.synchronize()
    for bb, g in got:
        want = int(sparse.count_tree_blocks_plain(KERNEL_PROGS[0], mats, bb))
        if int(g) != want:
            raise AssertionError(f"K2 on two streams: {int(g)} != {want}")
        n += 1
    # No shards at all: K2 still stores its (zero) result.
    got = sparse.count_tree_blocks_cuda(kernels.compile_prog(KERNEL_PROGS[0]),
                                        [m[:, :0].contiguous() for m in mats],
                                        torch.zeros(0, dtype=torch.int64, device=device))
    if int(got) != 0:
        raise AssertionError(f"K2 over no shards: {int(got)} != 0")
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
    """K3 (topn_tree, and the full TopN: gated totals and the trim in its
    last block) and P2 against their plain versions; returns max |err| of
    each."""
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
    # S = 6 shards: up to 129 candidates the launcher splits the words over
    # clusters of CTAs; at 1000 and 4096 it does not.  K = 1000 leaves a
    # partial group and a partial tile of the trim; K = 4096 is the most
    # the totals take.
    for K in (1, 8, 16, 128, 129, 1000, 4096):
        idx = rng.integers(0, R, K).astype(np.int32)
        cnt = rng.integers(0, 1 << 20, (K, S)).astype(np.int32)
        if K > 1:  # a tie: one row twice with the same counts
            idx[1], cnt[1] = idx[0], cnt[0]
        idx[K // 2:] = 0  # the later half: pad / absent slots, reading row 0
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
                n += 1
                # thr 1 << 30 gates every pair out: all-zero totals.
                for thr in (1, int(ws.float().mean()) + 1, 1 << 30):
                    want = kernels.topn_full_tree_plain(prog, mats, mask, cand, ci, cn, thr, None)
                    for n_out in sorted({None, 1, min(5, K), K}, key=lambda v: v or 0):
                        _, _, got = kernels.score_rows_cuda(code, mats, mask, cand, ci, scores=False,
                                                            cnt=cn, thr=thr, n_out=n_out)
                        torch.cuda.synchronize()
                        what = f"K={K} thr={thr} n_out={n_out} {prog} mask={m.tolist()}"
                        if n_out is None:
                            err["score_rows"] = max(err["score_rows"], _exact("K3", got, want, f"totals {what}"))
                        else:
                            wv, wi = kernels.topn_trim_plain(want, n_out)
                            err["topn_trim"] = max(err["topn_trim"], _exact("K3 trim", got[0], wv, f"vals {what}"),
                                                   _exact("K3 trim", got[1], wi, f"idx {what}"))
                        n += 1
    # Fused TopNs on two streams at once: each stream has its own totals
    # scratch, so launches that overlap still finish exactly.
    side = torch.cuda.Stream(device=device)
    code = kernels.compile_prog(TOPN_SRC_PROGS[1])
    K = 128
    ci = torch.from_numpy(rng.integers(0, R, K).astype(np.int32)).to(device)
    cn = torch.from_numpy(rng.integers(0, 1 << 20, (K, S)).astype(np.int32)).to(device)
    mask = torch.ones(S, dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    got = []
    for i in range(16):
        thr = 1 + 997 * i
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            got.append((thr, kernels.score_rows_cuda(code, mats, mask, cand, ci, scores=False,
                                                     cnt=cn, thr=thr, n_out=5)[2]))
    torch.cuda.synchronize()
    for thr, g in got:
        want = kernels.topn_full_tree_plain(TOPN_SRC_PROGS[1], mats, mask, cand, ci, cn, thr, 5)
        err["topn_trim"] = max(err["topn_trim"], _exact("K3 trim", g, torch.stack(want),
                                                        f"on two streams, thr={thr}"))
        n += 1
    for R2 in P2_CHECK_ROWS:
        # Row 0 all-ones words, row 1 sign bits only, the rest random.
        mat = torch.randint(-2 ** 31, 2 ** 31 - 1, (R2, 32768), dtype=torch.int32, device=device)
        mat[0] = -1
        if R2 > 1:
            mat[1] = -2 ** 31
        k = max(1, R2 // 2)
        row_lists = [None, rng.permutation(R2)[:k].tolist(), rng.permutation(R2).tolist(),
                     [R2 - 1], list(range(R2))]
        if R2 >= 2 * kernels.P2_MAX_LISTED:  # past the parameter list: a device list
            row_lists.append(rng.integers(0, R2, kernels.P2_MAX_LISTED + 88).tolist())
        for row in (mats[0][0, 1], mats[1][1, 0], torch.full((32768,), -1, dtype=torch.int32, device=device),
                    torch.full((32768,), -2 ** 31, dtype=torch.int32, device=device)):
            for rows in row_lists:
                got = kernels.and_popcount_rows_cuda(mat, row, rows)
                torch.cuda.synchronize()
                err["and_popcount_rows"] = max(
                    err["and_popcount_rows"],
                    _exact("P2", got, bitops.popcount_and_rows_plain(mat, row, rows),
                           f"R={R2} rows={'all' if rows is None else len(rows)}"))
                n += 1
    log(f"kernels: {n} comparisons exact (K3 with its trim, and P2, against plain versions)")
    err["topn_trim"] = max(err["topn_trim"], check_trim(device, seed))
    return err


# K9's checks: K_pad at each width its sorts take, slabs below and past the
# qualifiers, thresholds that gate nothing, some or every candidate.
SLAB_CHECK_K = (8, 64, 512, 4096)


def check_topn_slab(device, seed):
    """K9 topn_slab against its plain version (topn_slab_tree_plain) on the
    card: K_pad 8, 64, 512 and 4096; candidate rows repeated (equal scores)
    and cache counts drawn from a few values (ties in the walk), absent
    from a shard's cache (count 0) for about a third; thresholds that gate
    nothing, about half and every pair (fewer qualifiers than n); n_sel 0,
    1, 5 and K_pad; slabs of 1, 8 pairs and K_pad (qual > k_out); chain,
    interpreter and zero src trees; masks of every shard and a ragged set;
    two streams.  Returns {"topn_slab": max |err|}."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    rng = np.random.default_rng(seed + 9)
    err, n = 0, 0
    for K in SLAB_CHECK_K:
        S = 24 if K <= 512 else 6
        mats = [_adversarial_stack(rng, 4, S, device), _adversarial_stack(rng, 4, S, device)]
        R = 16
        cand = _adversarial_stack(rng, R, S, device)
        idx = rng.integers(0, R, K).astype(np.int32)  # rows repeat: equal scores
        cnt = rng.choice([0, 1 << 18, 1 << 19, 700000], size=(K, S)).astype(np.int32)
        ci = torch.from_numpy(idx).to(device)
        cn = torch.from_numpy(cnt).to(device)
        ragged = (rng.random(S) < 0.5).astype(np.int32)
        ragged[0] = 1
        for prog in TOPN_SRC_PROGS[:3] if K <= 64 else TOPN_SRC_PROGS[:1]:
            code = kernels.compile_prog(prog)
            for m in (np.ones(S, np.int32), ragged):
                mask = torch.from_numpy(m).to(device)
                scores, _ = kernels.topn_tree_plain(prog, mats, mask, cand, ci)
                mid = int(scores[scores > 0].float().median()) if (scores > 0).any() else 1
                for thr in (1, mid, 1 << 21):
                    for n_sel in sorted({0, 1, 5, K}):
                        for k_out in sorted({1, 8, K}):
                            got = kernels.topn_slab_cuda(code, mats, mask, cand, ci, cn, thr,
                                                         n_sel, k_out)
                            torch.cuda.synchronize()
                            want = kernels.slab_select_plain(scores, cn, thr, n_sel, k_out)
                            what = f"K_pad={K} {prog} thr={thr} n={n_sel} k_out={k_out}"
                            for g, w, part in zip(got, want, ("vals", "idx", "qual")):
                                err = max(err, _exact("K9", g, w, f"{part} {what}"))
                            n += 1
    # Launches overlapping on two streams, each against its plain version.
    S, K = 24, 64
    side = torch.cuda.Stream(device=device)
    mats = [_adversarial_stack(rng, 4, S, device)]
    cand = _adversarial_stack(rng, 8, S, device)
    ci = torch.from_numpy(rng.integers(0, 8, K).astype(np.int32)).to(device)
    cn = torch.from_numpy(rng.integers(0, 1 << 20, (K, S)).astype(np.int32)).to(device)
    mask = torch.ones(S, dtype=torch.int32, device=device)
    code = kernels.compile_prog(TOPN_SRC_PROGS[0])
    torch.cuda.synchronize()
    got = []
    for i in range(8):
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            got.append((i + 1, kernels.topn_slab_cuda(code, mats, mask, cand, ci, cn, 1, i + 1,
                                                      16)))
    torch.cuda.synchronize()
    for n_sel, g in got:
        want = kernels.topn_slab_tree_plain(TOPN_SRC_PROGS[0], mats, mask, cand, ci, cn, 1,
                                            n_sel, 16)
        for gg, w in zip(g, want):
            err = max(err, _exact("K9", gg, w, f"on two streams, n={n_sel}"))
        n += 1
    log(f"kernels: {n} comparisons exact (K9 topn_slab against topn_slab_tree_plain)")
    return {"topn_slab": err}


# The trim's own checks: K and n_out on both sides of its sort's widths
# (16 keys a thread, 512 a warp, the power of two above K).
TRIM_CHECK_K = (1, 8, 16, 128, 129, 257, 1000, 2048, 4096)
TRIM_CHECK_N_OUT = (1, 5, 64, 255, 256, 257)


def _trim_totals(rng, kind, K):
    """int64[K] totals of one kind: drawn, three levels (ties), all equal,
    all zero, or half at 2^31 - 1 (the largest total an int32 holds)."""
    if kind == "drawn":
        return rng.integers(0, 1 << 30, K)
    if kind == "ties":
        return rng.choice(np.array([0, 5, 1 << 20]), K)
    if kind == "equal":
        return np.full(K, 12345)
    if kind == "zero":
        return np.zeros(K, np.int64)
    return np.where(rng.random(K) < 0.5, 2 ** 31 - 1, rng.integers(0, 2 ** 31 - 1, K))


class TrimOnCard:
    """K3's trim on totals of the caller's choosing: they go into the
    current stream's totals scratch, then a K3 launch whose one shard is
    masked adds nothing to them, so its last block (past 256 candidates,
    score_rows_trim_kernel after it) trims exactly these (n_out None:
    copies them out).  Counts as a K3 launch."""

    def __init__(self, device):
        import torch

        from pilosa_tpu_torch.parallel import kernels

        self.kernels = kernels
        self.code = kernels.compile_prog(("row", 0, 0))
        self.mats = [torch.zeros((1, 1, 32768), dtype=torch.int32, device=device)]
        self.mask = torch.zeros(1, dtype=torch.int32, device=device)
        self.idx = torch.zeros(kernels.TOTALS_MAX, dtype=torch.int32, device=device)
        self.cnt = torch.zeros((kernels.TOTALS_MAX, 1), dtype=torch.int32, device=device)

    def __call__(self, totals, n_out):
        import torch

        K, dev = totals.shape[0], totals.device
        scratch = self.kernels._totals_scratch_for(dev, torch.cuda.current_stream(dev).cuda_stream)
        scratch[:K].copy_(totals)
        return self.kernels.score_rows_cuda(self.code, self.mats, self.mask, self.mats[0],
                                            self.idx[:K], scores=False, cnt=self.cnt[:K],
                                            n_out=n_out)[2]


def check_trim(device, seed):
    """K3's trim against topn_trim_plain, exactly, on totals set directly
    (TrimOnCard): K in TRIM_CHECK_K, n_out in TRIM_CHECK_N_OUT and K, and
    none (the totals copied out), totals drawn, tied, all equal, zero and
    at 2^31 - 1; then 16 launches alternating between two streams.
    Returns max |err|."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    rng = np.random.default_rng(seed + 17)
    trim = TrimOnCard(device)
    e, n = 0, 0
    for K in TRIM_CHECK_K:
        for kind in ("drawn", "ties", "equal", "zero", "int32_max"):
            totals = torch.from_numpy(_trim_totals(rng, kind, K).astype(np.int64)).to(device)
            for n_out in [None] + sorted({v for v in TRIM_CHECK_N_OUT if v <= K} | {K}):
                got = trim(totals, n_out)
                torch.cuda.synchronize()
                what = f"K={K} {kind} n_out={n_out}"
                if n_out is None:
                    e = max(e, _exact("K3 trim", got, totals, f"copied totals {what}"))
                else:
                    wv, wi = kernels.topn_trim_plain(totals, n_out)
                    e = max(e, _exact("K3 trim", got[0], wv, f"vals {what}"),
                            _exact("K3 trim", got[1], wi, f"idx {what}"))
                n += 1
    # Two streams at once: each has its own scratch.
    side = torch.cuda.Stream(device=device)
    torch.cuda.synchronize()
    pending = []
    for i in range(16):
        K = TRIM_CHECK_K[i % len(TRIM_CHECK_K)]
        totals = torch.from_numpy(_trim_totals(rng, "ties", K).astype(np.int64)).to(device)
        n_out = min(K, (1, 5, 257, K)[i % 4])
        stream = side if i % 2 else torch.cuda.default_stream(device)
        stream.wait_stream(torch.cuda.default_stream(device))  # the totals' upload
        with torch.cuda.stream(stream):
            pending.append((totals, n_out, trim(totals, n_out)))
    torch.cuda.synchronize()
    for totals, n_out, got in pending:
        want = torch.stack(kernels.topn_trim_plain(totals, n_out))
        e = max(e, _exact("K3 trim", got, want, f"on two streams, K={totals.shape[0]}"))
        n += 1
    log(f"kernels: {n} comparisons exact (K3's trim on totals set directly, against "
        "topn_trim_plain)")
    return e


def check_eval_tree(device, seed):
    """K10 eval_tree against eval_tree_plain, every word exact: the main
    path's trees and the zero tree over two adversarial stacks, with masks
    of every, no and a random half of the shards; range leaves of every
    kind over a BSI stack, alone and beside rows; pool leaves over a block
    pool (slot 0, a recycled slot, an empty row, every block); 31 shards
    (a ragged grid).  Returns max |err| (the differing words)."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    rng = np.random.default_rng(seed + 23)
    S = 12
    mats = [_adversarial_stack(rng, 4, S, device), _adversarial_stack(rng, 4, S, device)]
    masks = [torch.from_numpy(m).to(device) for m in (
        np.ones(S, np.int32), np.zeros(S, np.int32), (rng.random(S) < 0.5).astype(np.int32))]
    n, err = 0, 0

    def same(prog, mats, mask, what):
        nonlocal n, err
        got = kernels.eval_tree(prog, mats, mask)
        want = kernels.eval_tree_plain(prog, mats, mask)
        torch.cuda.synchronize()
        bad = int((got != want).sum()) if got.shape == want.shape else got.numel()
        err = max(err, bad)
        if bad:
            raise AssertionError(f"K10 {what}: {bad} words differ from eval_tree_plain")
        n += 1

    for prog in KERNEL_PROGS + [("zero",)]:
        for mask in masks:
            same(prog, mats, mask, f"{prog} mask={mask.tolist()}")
    depth = 8
    bmat = _bsi_stack(rng, depth, S, device)
    planes = list(range(depth)) + [depth]
    for kind in _BSI_KINDS:
        lo = int(rng.integers(0, 1 << depth))
        hi = int(rng.integers(lo, 1 << depth))
        leaf = _range_leaf(kind, planes, lo, hi)
        for prog in (leaf, ("and", leaf, ("row", 0, depth + 1)),
                     ("or", ("row", 0, depth + 2), leaf)):
            same(prog, [bmat], masks[2], f"range {kind} {prog}")
    pool, table = _pool_case(rng, S, 9, 6, device)
    pmats = [mats[0], pool, table]
    for prog in (("rowb", 1, 2, 0), ("and", ("rowb", 1, 2, 2), ("row", 0, 1)),
                 ("or", ("rowb", 1, 2, 5), ("rowb", 1, 2, 1)),
                 ("xor", ("row", 0, 3), ("rowb", 1, 2, 6)),
                 ("andnot", ("rowb", 1, 2, 3), ("and", ("row", 0, 0), ("rowb", 1, 2, 4)))):
        for mask in (masks[0], masks[2]):
            same(prog, pmats, mask, f"pool {prog}")
    S2 = 31
    mats2 = [_adversarial_stack(rng, 4, S2, device) for _ in range(2)]
    mask2 = torch.from_numpy((rng.random(S2) < 0.7).astype(np.int32)).to(device)
    for prog in KERNEL_PROGS:
        same(prog, mats2, mask2, f"{prog} over {S2} shards")
    log(f"kernels: {n} comparisons exact (K10 eval_tree against eval_tree_plain)")
    return err


def check_trim_alone(device, seed):
    """K3's trim launched alone (``kernels.score_rows_trim_cuda``, the mesh's
    TopN after the all-reduce) against topn_trim_plain, exactly: K in
    TRIM_CHECK_K, n_out in TRIM_CHECK_N_OUT and K, totals drawn, tied, all
    equal, zero and at 2^31 - 1, the caller's totals left as they were;
    then 16 launches alternating between two streams.  Returns max |err|."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    rng = np.random.default_rng(seed + 29)
    e, n = 0, 0
    for K in TRIM_CHECK_K:
        for kind in ("drawn", "ties", "equal", "zero", "int32_max"):
            totals = torch.from_numpy(_trim_totals(rng, kind, K).astype(np.int64)).to(device)
            kept = totals.clone()
            for n_out in sorted({v for v in TRIM_CHECK_N_OUT if v <= K} | {K}):
                got = kernels.score_rows_trim_cuda(totals, n_out)
                torch.cuda.synchronize()
                wv, wi = kernels.topn_trim_plain(kept, n_out)
                what = f"K={K} {kind} n_out={n_out}"
                e = max(e, _exact("K3 trim alone", got[0], wv, f"vals {what}"),
                        _exact("K3 trim alone", got[1], wi, f"idx {what}"),
                        _exact("K3 trim alone", totals, kept, f"caller's totals {what}"))
                n += 1
    side = torch.cuda.Stream(device=device)
    torch.cuda.synchronize()
    pending = []
    for i in range(16):
        K = TRIM_CHECK_K[i % len(TRIM_CHECK_K)]
        totals = torch.from_numpy(_trim_totals(rng, "ties", K).astype(np.int64)).to(device)
        n_out = min(K, (1, 5, 257, K)[i % 4])
        stream = side if i % 2 else torch.cuda.default_stream(device)
        stream.wait_stream(torch.cuda.default_stream(device))
        with torch.cuda.stream(stream):
            pending.append((totals, n_out, kernels.score_rows_trim_cuda(totals, n_out)))
    torch.cuda.synchronize()
    for totals, n_out, got in pending:
        want = torch.stack(kernels.topn_trim_plain(totals, n_out))
        e = max(e, _exact("K3 trim alone", got, want, f"on two streams, K={totals.shape[0]}"))
        n += 1
    log(f"kernels: {n} comparisons exact (K3's trim alone, against topn_trim_plain)")
    return e


_OPS = ("and", "or", "andnot", "xor")


def _rand_tree(rng, leaves, chain):
    """A normalized tree over ``leaves`` (each ("row", m, r) or ("zero",)):
    one n-ary node of leaves (the chain form K1 and K5 run in registers),
    or nested binary nodes (their stack interpreter)."""
    if len(leaves) == 1:
        return leaves[0]
    if chain:
        return (_OPS[int(rng.integers(0, 4))],) + tuple(leaves)
    cut = int(rng.integers(1, len(leaves)))
    return (_OPS[int(rng.integers(0, 4))], _rand_tree(rng, leaves[:cut], False),
            _rand_tree(rng, leaves[cut:], False))


def _rand_batch(rng, K, rows_of, n_leaves=(1, 6), zero=0.1):
    """K random trees; ``rows_of()`` draws one (m, r) leaf row."""
    progs = []
    for k in range(K):
        leaves = [("zero",) if rng.random() < zero else ("row",) + rows_of()
                  for _ in range(int(rng.integers(n_leaves[0], n_leaves[1])))]
        progs.append(_rand_tree(rng, leaves, chain=k % 2 == 0))
    return progs


def _batch_masks(rng, S):
    """bool[5, S] masks: none, all, one shard, the last shard, ragged."""
    m = np.zeros((5, S), dtype=bool)
    m[1] = True
    m[2, int(rng.integers(0, S))] = True
    m[3, S - 1] = True
    m[4] = rng.random(S) < 0.5
    return m


def check_batch_kernel(device, seed):
    """K5 count_batch_tree against count_batch_tree_plain: K in {1, 2, 8,
    9, 64, 65, 256, 512}, duplicate queries (the fan-out), zero trees,
    masks of no shard, every shard, one shard and a ragged set, leaves of
    two stacks, 128 and 1024 distinct leaf rows (a staged and an unstaged
    leaf table), 37 shards (two mask words), no shards, chain and
    interpreter trees over adversarial words, and launches overlapping on
    two streams.  Returns max |err|."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    rng = np.random.default_rng(seed + 5)
    n = 0

    def check(progs, mats, masks, mask_ids, what, out_index=None):
        got = kernels.count_batch_tree_cuda(kernels.compile_batch(progs, mask_ids), mats, masks,
                                            device, out_index)
        return (progs, mats, masks, mask_ids, what, out_index, got)

    def settle(pending):
        nonlocal n
        torch.cuda.synchronize()
        for progs, mats, masks, mask_ids, what, out_index, got in pending:
            want = kernels.count_batch_tree_plain(progs, mats, masks, mask_ids, device, out_index)
            _exact("K5", got, want, what)
            n += 1

    S = 12
    mats = [_adversarial_stack(rng, 4, S, device), _adversarial_stack(rng, 4, S, device)]
    masks = _batch_masks(rng, S)
    rows_of = lambda: (int(rng.integers(0, 2)), int(rng.integers(0, 4)))  # noqa: E731
    for K in (1, 2, 8, 9, 64, 65, 256, 512):
        progs = _rand_batch(rng, K, rows_of)
        ids = rng.integers(0, len(masks), K).tolist()
        settle([check(progs, mats, masks, ids, f"K={K}")])
        # Duplicates: the batch of unique queries fanned out to K callers.
        fan = rng.integers(0, K, K + 3).tolist()
        settle([check(progs, mats, masks, ids, f"K={K} fanned out", out_index=fan)])
    # Every mask on every query, and zero trees / absent rows alone.
    progs = [("zero",), ("and", ("row", 0, 0), ("zero",)), ("row", 1, 1), KERNEL_PROGS[6],
             KERNEL_PROGS[9], ("or", ("zero",), ("zero",))]
    settle([check(progs * len(masks), mats, masks,
                  [i for i in range(len(masks)) for _ in progs], "each mask")])
    # 37 shards: a mask of two words.
    mats37 = [_adversarial_stack(rng, 4, 37, device) for _ in range(2)]
    masks37 = _batch_masks(rng, 37)
    progs = _rand_batch(rng, 40, rows_of)
    settle([check(progs, mats37, masks37, rng.integers(0, 5, 40).tolist(), "37 shards")])
    del mats37
    # Wide leaf tables: 128 distinct rows (staged in shared memory) and
    # 1024 (read from device memory), over 3 shards of a 1024-row stack.
    gen = torch.Generator(device=device).manual_seed(seed)
    big = torch.randint(-2 ** 31, 2 ** 31 - 1, (1024, 3, 32768), dtype=torch.int32, device=device,
                        generator=gen)
    big[0] = -1
    big[1] = -2 ** 31
    big[2] = 0
    masks3 = _batch_masks(rng, 3)
    for width, K in ((128, 64), (1024, 512)):
        rows = rng.permutation(width)
        progs = [_rand_tree(rng, [("row", 0, int(r)) for r in rows[2 * k: 2 * k + 2]], k % 2 == 0)
                 for k in range(width // 2)]
        progs += _rand_batch(rng, K - len(progs), lambda: (0, int(rng.integers(0, width))))
        assert len(kernels.compile_batch(progs, [0] * K).leaves) == width
        settle([check(progs, [big], masks3, rng.integers(0, 5, K).tolist(),
                      f"{width} distinct leaves")])
    del big
    # No shards: K5 still writes its (zero) answers.
    empty = [m[:, :0].contiguous() for m in mats]
    got = kernels.count_batch_tree(KERNEL_PROGS[:3], empty, np.zeros((1, 0), bool), [0, 0, 0],
                                   device)
    if got.tolist() != [0, 0, 0]:
        raise AssertionError(f"K5 over no shards: {got.tolist()}")
    n += 1
    # Two streams at once: each keeps its own totals scratch.
    side = torch.cuda.Stream(device=device)
    torch.cuda.synchronize()
    pending = []
    for i in range(16):
        progs = _rand_batch(rng, 33, rows_of)
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            pending.append(check(progs, mats, masks, rng.integers(0, 5, 33).tolist(),
                                 f"two streams, launch {i}"))
    settle(pending)
    # Past the launch's query limit: refused before launch.
    try:
        kernels.count_batch_tree_cuda(kernels.compile_batch([("zero",)] * (kernels.BATCH_MAX + 1),
                                                            [0] * (kernels.BATCH_MAX + 1)),
                                      mats, masks, device)
    except ValueError:
        pass
    else:
        raise AssertionError(f"K5 launched {kernels.BATCH_MAX + 1} queries")
    log(f"kernels: {n} comparisons exact (K5 count_batch_tree against its plain version)")
    return {"count_batch_tree": 0}


def _bsi_stack(rng, depth, S, device, extra=2):
    """int32[depth + 1 + extra, S, W]: BSI planes 0..depth-1, the not-null
    plane at row depth, then ``extra`` rows of random words.  Adversarial
    shards: 0 every plane all ones, 1 the sign bit only, 2 every plane zero,
    3 not-null all ones over random planes, 4 not-null zero."""
    import torch

    R = depth + 1 + extra
    words = rng.integers(0, 1 << 32, (R, S, 32768), dtype=np.uint64).astype(np.uint32)
    words[:, 0] = 0xFFFFFFFF
    words[:, 1] = 0x80000000
    words[:, 2] = 0
    words[depth, 3] = 0xFFFFFFFF
    words[depth, 4] = 0
    return torch.from_numpy(words.view(np.int32)).to(device)


# Predicates of every range check: 0, 2^31, 2^63 - 1 (only the bits below
# the depth are walked) and two drawn below 2^depth per depth.
_BSI_PREDS = (0, 1 << 31, (1 << 63) - 1)
_BSI_KINDS = ("eq", "neq", "lt", "lte", "gt", "gte", "between")


def _range_leaf(kind, planes, lo, hi, slot=0):
    return ("range", kind, slot, tuple(planes), lo, hi if kind == "between" else 0)


def check_bsi_kernels(device, seed):
    """KR (the range leaf of csrc/tree_eval.cuh, through K1, K2 and K3),
    K6 sum_tree and K7 minmax_tree against their plain versions, exactly:
    depths 1, 8, 31, 32 and 63 (and 0 for K6/K7), every kind and BETWEEN,
    predicates 0, 2^31, 2^63 - 1 and drawn ones, adversarial planes, a
    missing value plane and a missing not-null plane, chain and
    interpreter trees with one, two and four range leaves (five are
    refused), filters with and without range leaves, masked and ragged
    shards (12, 31), K2's block words, and launches overlapping on two
    streams.  Returns max |err| of each."""
    import torch

    from pilosa_tpu_torch.parallel import bsi, kernels, sparse

    rng = np.random.default_rng(seed + 7)
    err = {"range_leaf": 0, "sum_tree": 0, "minmax_tree": 0}
    n = 0

    def same(name, key, got, want, what):
        nonlocal n
        torch.cuda.synchronize()
        got = torch.as_tensor(got).reshape(-1)
        want = torch.as_tensor(want).reshape(-1).to(got.device)
        err[key] = max(err[key], _exact(name, got, want, what))
        n += 1

    for S in (12, 31):
        rows = _adversarial_stack(rng, 4, S, device)
        masks = [np.ones(S, np.int32), np.zeros(S, np.int32),
                 (rng.random(S) < 0.5).astype(np.int32)]
        masks = [torch.from_numpy(m).to(device) for m in masks]
        cases = _block_word_cases(rng, S)[::3]
        for depth in ((0, 1, 8, 31, 32, 63) if S == 12 else (8, 63)):
            st = _bsi_stack(rng, depth, S, device)
            mats = [st, rows]
            full = tuple(range(depth + 1))
            variants = [full]
            if depth:
                gap = list(full)
                gap[depth // 2] = -1  # a value plane the stack lacks
                nn_gone = list(full)
                nn_gone[depth] = -1  # no not-null plane: every condition is empty
                variants += [tuple(gap), tuple(nn_gone)]
            preds = list(_BSI_PREDS)
            if depth:
                preds += [int(x) for x in rng.integers(0, 1 << min(depth, 62), 2)]
            for planes in variants:
                for m in masks:
                    got = bsi.sum_tree_cuda(None, [], m, st, planes)
                    same("K6", "sum_tree", got, bsi.sum_tree_plain(None, [], m, st, planes),
                         f"depth {depth} planes {planes[:3]}.. unfiltered")
                    for is_min in (True, False):
                        got = bsi.minmax_tree_cuda(None, [], m, st, planes, is_min)
                        want = bsi.minmax_tree_plain(None, [], m, st, planes, is_min)
                        same("K7", "minmax_tree", torch.stack(got), torch.stack(want),
                             f"depth {depth} min={is_min} unfiltered")
                if not depth:
                    continue
                for kind in _BSI_KINDS:
                    for lo in preds:
                        hi = preds[int(rng.integers(0, len(preds)))]
                        leaf = _range_leaf(kind, planes, lo, hi)
                        leaf2 = _range_leaf(_BSI_KINDS[int(rng.integers(0, 7))], planes,
                                            preds[int(rng.integers(0, len(preds)))], lo)
                        progs = [leaf, ("and", ("row", 1, 0), leaf),
                                 ("or", ("and", ("row", 1, 1), leaf),
                                  ("andnot", ("row", 1, 2), leaf2))]
                        for prog in progs:
                            code = kernels.compile_prog(prog)
                            m = masks[int(rng.integers(0, 3))]
                            what = f"depth {depth} {prog[0]} {kind} {lo} {hi} S={S}"
                            same("KR (K1)", "range_leaf", kernels.count_tree_dense(code, mats, m),
                                 kernels.count_tree_plain(prog, mats, m), what)
                        # K2 over block words, K3 scoring against the range.
                        prog = progs[1]
                        code = kernels.compile_prog(prog)
                        _, bits = cases[int(rng.integers(0, len(cases)))]
                        bb = torch.from_numpy(bits.view(np.int64)).to(device)
                        same("KR (K2)", "range_leaf", sparse.count_tree_blocks_cuda(code, mats, bb),
                             sparse.count_tree_blocks_plain(prog, mats, bb), f"{what} blocks")
                        ci = torch.from_numpy(rng.integers(0, 4, 8).astype(np.int32)).to(device)
                        m = masks[2]
                        sc, cn, _ = kernels.score_rows_cuda(code, mats, m, rows, ci, src_counts=True)
                        ws, wc = kernels.topn_tree_plain(prog, mats, m, rows, ci)
                        same("KR (K3)", "range_leaf", torch.cat([sc.reshape(-1), cn]),
                             torch.cat([ws.reshape(-1), wc]), f"{what} scores")
                        # Sum and Min/Max filtered by a tree with a range leaf.
                        if kind in ("lt", "between"):
                            for filt in (prog, ("row", 1, 3), ("zero",)):
                                m = masks[int(rng.integers(0, 3))]
                                code = kernels.compile_prog(filt)
                                same("K6", "sum_tree", bsi.sum_tree_cuda(code, mats, m, st, planes),
                                     bsi.sum_tree_plain(filt, mats, m, st, planes), f"{what} filtered")
                                for is_min in (True, False):
                                    got = bsi.minmax_tree_cuda(code, mats, m, st, planes, is_min)
                                    want = bsi.minmax_tree_plain(filt, mats, m, st, planes, is_min)
                                    same("K7", "minmax_tree", torch.stack(got), torch.stack(want),
                                         f"{what} filtered min={is_min}")
            # Four range leaves in one tree (the most a tree takes), and five
            # are refused before launch.
            if depth:
                four = ("and",) + tuple(_range_leaf(k, full, int(p), 0) for k, p in
                                        zip(("gt", "lt", "neq", "gte"), rng.integers(0, 1 << min(depth, 62), 4)))
                code = kernels.compile_prog(four)
                same("KR (K1)", "range_leaf", kernels.count_tree_dense(code, mats, masks[0]),
                     kernels.count_tree_plain(four, mats, masks[0]), f"depth {depth} four range leaves")
                five = four + (_range_leaf("eq", full, 1, 0),)
                try:
                    kernels.count_tree(five, mats, masks[0])
                except ValueError:
                    pass
                else:
                    raise AssertionError("a tree of five range leaves was launched")
            del st
    # Two streams at once: K1 range counts and K6 sums interleaved.
    st = _bsi_stack(rng, 8, 12, device)
    rows = _adversarial_stack(rng, 4, 12, device)
    mask = torch.ones(12, dtype=torch.int32, device=device)
    side = torch.cuda.Stream(device=device)
    full = tuple(range(9))
    torch.cuda.synchronize()
    pending = []
    for i in range(16):
        prog = ("and", ("row", 1, i % 4), _range_leaf(_BSI_KINDS[i % 7], full, 17 * i, 200))
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            code = kernels.compile_prog(prog)
            pending.append((prog, kernels.count_tree_dense(code, [st, rows], mask),
                            bsi.sum_tree_cuda(code, [st, rows], mask, st, full)))
    torch.cuda.synchronize()
    for prog, cnt, sm in pending:
        same("KR (K1)", "range_leaf", cnt, kernels.count_tree_plain(prog, [st, rows], mask),
             f"two streams {prog[2][1]}")
        same("K6", "sum_tree", sm, bsi.sum_tree_plain(prog, [st, rows], mask, st, full),
             "two streams")
    log(f"kernels: {n} comparisons exact (the range leaf in K1, K2 and K3, K6 sum_tree and "
        "K7 minmax_tree against plain versions)")
    return err


def check_batch_ranges(device, seed):
    """K5 with range leaves against count_batch_tree_plain, exactly: depths
    1, 8, 31 and 63, every kind and BETWEEN at drawn and extreme
    predicates, a missing value plane and a missing not-null plane, two
    ranges over one field, ranges beside rows, chain and interpreter
    trees, the same condition in several queries (walked once), four
    range leaves in one tree, masks of every shard, none, one and a
    ragged set; two and three depth-63 fields (128 and 192 plane rows)
    alone, beside 40 rows read as rows (the narrowest staged tile) and
    beside 65 (past the stage: the direct path); 1, 8, 12 and 16
    conditions on one depth-8 field (one group), strict kinds at their
    edges among them; two fields in one batch.  Returns max |err|."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    rng = np.random.default_rng(seed + 9)
    n = 0

    def same(progs, mats, masks, what):
        nonlocal n
        ids = [int(i) for i in rng.integers(0, len(masks), len(progs))]
        batch = kernels.compile_batch(progs, ids)
        got = kernels.count_batch_tree_cuda(batch, mats, masks, device)
        torch.cuda.synchronize()
        _exact("K5", got, kernels.count_batch_tree_plain(progs, mats, masks, ids, device),
               f"{what} ({len(batch.leaves)} table rows, {batch.ranges.shape[0]} ranges)")
        n += 1

    S = 12
    rows = _adversarial_stack(rng, 4, S, device)
    masks = _batch_masks(rng, S)
    for depth in (1, 8, 31, 63):
        st = _bsi_stack(rng, depth, S, device)
        mats = [st, rows]
        full = tuple(range(depth + 1))
        gap = tuple(-1 if i == depth // 2 else i for i in full)
        nn_gone = full[:-1] + (-1,)
        preds = list(_BSI_PREDS) + [int(x) for x in rng.integers(0, 1 << min(depth, 62), 3)]
        progs = []
        for kind in _BSI_KINDS:
            for planes in (full, gap, nn_gone):
                lo, hi = preds[int(rng.integers(0, len(preds)))], preds[int(rng.integers(0, len(preds)))]
                leaf = _range_leaf(kind, planes, lo, hi)
                other = _range_leaf(_BSI_KINDS[int(rng.integers(0, 7))], full,
                                    preds[int(rng.integers(0, len(preds)))], lo)
                progs += [leaf, ("and", ("row", 1, int(rng.integers(0, 4))), leaf),
                          ("or", ("and", ("row", 1, 1), leaf), ("andnot", ("row", 1, 2), other)),
                          ("xor", leaf, other, ("zero",))]
        four = ("and",) + tuple(_range_leaf(k, full, int(p), 0) for k, p in
                                zip(("gt", "lt", "neq", "gte"), rng.integers(0, 1 << min(depth, 62), 4)))
        progs.append(four)
        same(progs, mats, masks, f"depth {depth}, {len(progs)} queries")
        same(progs[::9] * 3, mats, masks, f"depth {depth}, repeats")
        del st
    # Two and three depth-63 fields (128 and 192 plane rows in the table;
    # the grouped pass reads planes from device memory, so both stage only
    # their range rows), each range in several queries; then 65 and 40 rows
    # read as rows beside them: past the 128-row stage (the direct path)
    # and the stage's narrowest tiles (32 positions, U = 1).
    sts = [_bsi_stack(rng, 63, S, device, extra=0) for _ in range(3)]
    full = tuple(range(64))
    for n_st in (2, 3):
        progs = [_range_leaf(_BSI_KINDS[k % 7], full, int(rng.integers(0, 1 << 62)),
                             int(rng.integers(0, 1 << 62)), slot=k % n_st) for k in range(12)]
        progs += [("and", progs[k], progs[k + 1]) for k in range(0, 10, 3)]
        batch = kernels.compile_batch(progs, [0] * len(progs))
        assert len(batch.leaves) == 64 * n_st and kernels.batch_tile(batch) == 256, \
            (len(batch.leaves), kernels.batch_tile(batch))
        same(progs, sts, masks, f"{64 * n_st} plane rows")
        for n_rows, tile in ((65, 0), (40, 32)):
            rows = [("or",) + tuple(("row", 2 - r // 64, r % 64)
                                    for r in range(q, min(q + 20, n_rows)))
                    for q in range(0, n_rows, 20)]
            wide = progs + [("and", progs[k % 12], rows[k]) for k in range(len(rows))]
            assert kernels.batch_tile(kernels.compile_batch(wide, [0] * len(wide))) == tile
            same(wide, sts, masks, f"{64 * n_st} plane rows, {n_rows} rows read as rows "
                 f"({'direct' if not tile else f'tile {tile}'})")
    del sts
    # Conditions on one depth-8 field like the bsi phase's v: 1, 8, 12 and
    # 16 in a batch (one group, walked once a position), with NEQ, BETWEEN
    # and the strict kinds at their edges (1 and 255, empty walks) among
    # them; then two fields (v and a depth-16 one) in one batch, a plane
    # read as a row, a missing plane.
    v = _bsi_stack(rng, 8, S, device)
    w = _bsi_stack(rng, 16, S, device)
    fv, fw = tuple(range(9)), tuple(-1 if i == 5 else i for i in range(17))
    edge = [("gt", 255, 0), ("lt", 1, 0), ("gt", 254, 0), ("lt", 0, 0), ("neq", 0, 0),
            ("between", 7, 3)]
    for n_cond in (1, 8, 12, 16):
        conds = [(_BSI_KINDS[k % 7], int(x), int(x) + 60)
                 for k, x in enumerate(rng.integers(0, 256, n_cond))]
        conds[:len(edge)] = edge[:n_cond]
        progs = [_range_leaf(k, fv, lo, hi) for k, lo, hi in conds]
        batch = kernels.compile_batch(progs, [0] * len(progs))
        assert batch.groups.tolist() == [[0, n_cond, 8, 0]] and batch.n_rows == 0
        same(progs + [("and", progs[0], ("row", 0, 9))], [v], masks, f"{n_cond} conditions on v")
    progs = [_range_leaf("gt", fv, 100, 0), _range_leaf("between", fw, 300, 40000, slot=1),
             ("or", ("row", 0, 4), _range_leaf("lte", fv, 77, 0)),
             ("andnot", _range_leaf("neq", fw, 12345, 0, slot=1), ("row", 1, 3)),
             ("and", _range_leaf("gt", fv, 100, 0), _range_leaf("lt", fw, 999, 0, slot=1))]
    batch = kernels.compile_batch(progs, [0] * len(progs))
    assert batch.groups.shape[0] == 2 and batch.n_rows == 2
    same(progs, [v, w], masks, "two fields")
    del v, w
    log(f"kernels: {n} comparisons exact (K5 with range leaves against its plain version)")
    return {"count_batch_tree": 0}


# Row lists of the K8 checks, by field: (stack, K), K rows drawn from the
# stack (a 4-row and a 33-row one); 1 to 8 fields, K of 1, 2, 4, 32 and 33,
# up to 1024 combinations (32 x 32).  The register form takes the shapes
# of at most 4 fields with one field of up to 4 rows and the others of up
# to 2 (C up to 32: 4 x 2 x 2 x 2 and 2 x 2 x 4 x 2, reordered); the walk
# every other (C = 33 and 1024 among them, up to 32 rows staged).
_GROUP_SHAPES = [
    (("g4", 1),), (("g4", 4),), (("g33", 33),),
    (("g4", 4), ("g4", 2)), (("g4", 2), ("g4", 3)), (("g33", 33), ("g4", 1)),
    (("g33", 32), ("g33", 32)), (("g4", 2), ("g33", 33)),
    (("g4", 4), ("g4", 2), ("g4", 2)), (("g4", 1), ("g4", 4), ("g33", 33)),
    (("g4", 2), ("g4", 2), ("g4", 2), ("g4", 2)),
    (("g4", 4), ("g4", 2), ("g4", 2), ("g4", 2)), (("g4", 2), ("g4", 2), ("g4", 4), ("g4", 2)),
    (("g4", 4), ("g4", 2), ("g4", 1), ("g33", 33)),
    (("g4", 1), ("g4", 2), ("g4", 1), ("g4", 2), ("g33", 33)),
    (("g4", 2),) * 5 + (("g4", 1),), (("g4", 2),) * 6 + (("g33", 2),),
    (("g4", 2),) * 8,
]


def check_groupby_kernel(device, seed):
    """K8 groupn_tree against groupn_tree_plain, exactly: 1 to 8 fields, K
    of 1, 2, 3, 4, 32 and 33 (up to 1024 combinations; 1025 is refused
    before launch), the register form and the walk, rows drawn at random with repeats and a row
    the stack lacks (-1), adversarial words (all-ones, sign bit only,
    zero, sparse rows), no filter, a one-leaf chain, an interpreter tree
    and one to four range leaves, masks of no shard, every shard and a
    ragged set, 12 and 37 shards, and launches overlapping on two
    streams.  Returns max |err|."""
    import torch

    from pilosa_tpu_torch.parallel import groupby

    rng = np.random.default_rng(seed + 13)
    err = {"groupn_tree": 0}
    n = n_reg = 0

    def same(got, want, what):
        nonlocal n
        torch.cuda.synchronize()
        err["groupn_tree"] = max(err["groupn_tree"], _exact("K8", got, want.to(got.device), what))
        n += 1

    for S in (12, 37):
        stacks = {"g4": _adversarial_stack(rng, 4, S, device),
                  "g33": _adversarial_stack(rng, 33, S, device)}
        bst = _bsi_stack(rng, 8, S, device)
        mats = [_adversarial_stack(rng, 4, S, device), _adversarial_stack(rng, 4, S, device), bst]
        full = tuple(range(9))
        ranges = [_range_leaf(k, full, int(p), 200, slot=2)
                  for k, p in zip(("gt", "lt", "between", "neq"), rng.integers(0, 256, 4))]
        filters = [None, ("row", 1, 2), KERNEL_PROGS[6], ("and", ("row", 0, 1), ranges[0]),
                   ("or",) + tuple(ranges[:2]), ("and",) + tuple(ranges), ("zero",)]
        masks = [torch.from_numpy(m).to(device) for m in (
            np.ones(S, np.int32), np.zeros(S, np.int32), (rng.random(S) < 0.5).astype(np.int32))]
        for shape in _GROUP_SHAPES:
            fmats = [stacks[name] for name, _ in shape]
            lists = []
            for name, k in shape:
                R = stacks[name].shape[0]
                rows = rng.permutation(R)[:k].tolist() if k < R else list(range(R))
                if k > 2 and rng.random() < 0.5:
                    rows[int(rng.integers(0, k))] = -1  # a row the stack lacks
                if k > 3 and rng.random() < 0.5:
                    rows[0] = rows[1]  # a repeated row
                lists.append(rows)
            n_reg += groupby.groupn_plan([k for _, k in shape])[0] == "registers"
            for fi, prog in enumerate(filters):
                mask = masks[0] if fi == 0 else masks[int(rng.integers(0, 3))]
                code = None if prog is None else _checked(prog)
                want = groupby.groupn_tree_plain(prog, mats, mask, fmats, lists)
                got = groupby.groupn_tree_cuda(code, mats, mask, fmats, lists)
                same(got, want, f"S={S} {[k for _, k in shape]} filter {fi}")
            for mask in masks[1:]:
                want = groupby.groupn_tree_plain(None, mats, mask, fmats, lists)
                same(groupby.groupn_tree_cuda(None, mats, mask, fmats, lists),
                     want, f"S={S} {[k for _, k in shape]} mask {int(mask.sum())}")
        try:
            groupby.groupn_tree(None, mats, masks[0], [stacks["g33"]] * 2, [[0] * 41, [0] * 25])
        except ValueError:
            pass
        else:
            raise AssertionError("K8 launched 1025 combinations")
        if S == 12:
            # Two streams at once: every launch has its own output.
            side = torch.cuda.Stream(device=device)
            torch.cuda.synchronize()
            pending = []
            for i in range(12):
                # The walk (2 x 33) and the register form (2 x 2) in turns.
                lists = [[i % 4, (i + 1) % 4], list(range(33)) if i % 4 < 2 else [i % 3, 32]]
                prog = filters[i % len(filters)]
                with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
                    code = None if prog is None else _checked(prog)
                    pending.append((prog, lists, groupby.groupn_tree_cuda(
                        code, mats, masks[0], [stacks["g4"], stacks["g33"]], lists)))
            torch.cuda.synchronize()
            for prog, lists, got in pending:
                same(got, groupby.groupn_tree_plain(prog, mats, masks[0],
                                                    [stacks["g4"], stacks["g33"]], lists),
                     f"two streams, {len(lists[1])} rows")
        del stacks, bst, mats
    log(f"kernels: {n} comparisons exact (K8 groupn_tree against its plain version; "
        f"{n_reg // 2} of {len(_GROUP_SHAPES)} shapes in the register form, the rest "
        "in the walk)")
    return err


def _checked(prog):
    from pilosa_tpu_torch.parallel import kernels

    code = kernels.compile_prog(prog)
    kernels.check_prog(code)
    return code


def _rand_slots(rng, n_slots, leaves, ranges, p_range=0.15):
    """A random flat slot table of ``n_slots`` slots for F1: each slot a
    leaf row, a range leaf, zero, or a node (and/or/andnot/xor) over one to
    four of those and references to earlier slots (mref chains), at most
    ``len(ranges)`` distinct range leaves in all."""
    ops = ("and", "or", "andnot", "xor")

    def item(k):
        u = rng.random()
        if k and u < 0.45:
            return ("mref", int(rng.integers(0, k)))
        if u < 0.45 + p_range and ranges:
            return ranges[int(rng.integers(0, len(ranges)))]
        if u > 0.95:
            return ("zero",)
        return leaves[int(rng.integers(0, len(leaves)))]

    slots = []
    for k in range(n_slots):
        if rng.random() < 0.25:
            slots.append(item(k))
        else:
            kids = [item(k) for _ in range(int(rng.integers(1, 5)))]
            if k and rng.random() < 0.5:
                kids[0] = ("mref", k - 1)  # a chain through every slot
            slots.append((ops[int(rng.integers(0, 4))],) + tuple(kids))
    return tuple(slots)


def check_fused_kernel(device, seed):
    """F1 fused_tree against fused_slots_plain / fused_tree_plain, exactly:
    random flat slot tables of 1 to 16 slots (mref chains through every
    slot, repeated and xor-cancelling references, ANDNOT with an mref on
    its left, leaf rows of two stacks, zeros, one to four range leaves),
    up to 32 count edges on random slots with per-edge gates (none, every
    shard, ragged sets), materialized slots with and without a ``need``
    gate (compared inside it), adversarial words, 12 and 37 shards, F1 on
    two streams at once (a scratch per stream); then whole drains
    (kernels.fused_tree: F1 and the K6, K7, K3 and K8 edges on materialized
    slots) against fused_tree_plain; 17 slots and 33 count edges refused.
    Returns max |err|."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    rng = np.random.default_rng(seed + 29)
    err = {"fused_tree": 0}
    n = 0

    def same(got, want, what):
        nonlocal n
        torch.cuda.synchronize()
        err["fused_tree"] = max(err["fused_tree"], _exact("F1", got, want.to(got.device), what))
        n += 1

    for S in (12, 37):
        mats = [_adversarial_stack(rng, 6, S, device), _adversarial_stack(rng, 6, S, device),
                _bsi_stack(rng, 8, S, device)]
        leaves = [("row", m, r) for m in (0, 1) for r in range(6)]
        full = tuple(range(9))
        ranges = [_range_leaf(k, full, int(p), 200, slot=2)
                  for k, p in zip(("gt", "lt", "between", "neq"), rng.integers(0, 256, 4))]
        gate_pool = [np.ones(S, np.int32), np.zeros(S, np.int32)] + [
            (rng.random(S) < q).astype(np.int32) for q in (0.2, 0.5, 0.8)]
        for n_slots in (1, 2, 3, 4, 5, 8, 9, 12, 16):
            for trial in range(3):
                slots = _rand_slots(rng, n_slots, leaves, ranges[:1 + trial % 4],
                                    p_range=0.0 if trial == 0 else 0.15)
                E = int(rng.integers(1, kernels.MAX_FUSED_EDGES + 1)) if trial == 2 else \
                    int(rng.integers(1, 5))
                cslots = [int(j) for j in rng.integers(0, n_slots, E)]
                gnp = [gate_pool[int(rng.integers(0, len(gate_pool)))] for _ in range(E)]
                gates = [torch.from_numpy(g).to(device) for g in gnp]
                msl = sorted({int(j) for j in rng.integers(0, n_slots, int(rng.integers(0, 4)))})
                # Trials 1 and 2 keep only the slots an edge reads: one-row
                # slots outside them compile into their readers.
                code = kernels.compile_fused(
                    slots, frozenset(cslots) | frozenset(msl) if trial else None)
                kernels.check_fused(code)
                need_np = None
                if trial == 1:
                    need_np = np.logical_or.reduce(gnp + [rng.random(S) < 0.3]).astype(np.int32)
                need = None if need_np is None else torch.from_numpy(need_np).to(device)
                counts, mat = kernels.fused_tree_cuda(code, mats, cslots, gates, msl, need)
                vals = kernels.fused_slots_plain(slots, mats, (S, 32768), device)
                want = torch.stack([
                    (kernels.bitops.popcount_words(vals[j][g != 0]).sum())
                    for j, g in zip(cslots, gates)]).to(torch.int64)
                same(counts, want, f"S={S} {n_slots} slots trial {trial}: counts")
                for i, j in enumerate(msl):
                    keep = slice(None) if need_np is None else torch.from_numpy(
                        need_np != 0).to(device)
                    same(mat[i][keep], vals[j][keep], f"S={S} {n_slots} slots: slot {j}")
        # Two streams at once, each F1 with its own scratch.
        side = torch.cuda.Stream(device=device)
        torch.cuda.synchronize()
        pending = []
        for i in range(8):
            slots = _rand_slots(rng, 6, leaves, ranges[:2])
            code = kernels.compile_fused(slots)
            g = torch.from_numpy(gate_pool[i % len(gate_pool)]).to(device)
            with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
                c, m = kernels.fused_tree_cuda(code, mats, [5, 3], [g, g], [5])
                pending.append((slots, g, c, m.clone()))
        torch.cuda.synchronize()
        for slots, g, c, m in pending:
            vals = kernels.fused_slots_plain(slots, mats, (S, 32768), device)
            want = torch.stack([kernels.bitops.popcount_words(vals[j][g != 0]).sum()
                                for j in (5, 3)]).to(torch.int64)
            same(c, want, "two streams: counts")
            same(m[0], vals[5], "two streams: slot 5")
        # Whole drains: F1 then every aggregate edge kind on its slots.
        if S == 12:
            cand = _adversarial_stack(rng, 8, S, device)
            dmats = mats + [cand]
            masks = [torch.from_numpy(g).to(device) for g in gate_pool[:1] + gate_pool[2:]]
            cnt = torch.from_numpy(rng.integers(0, 3, (8, S)).astype(np.int32)).to(device)
            tensors = [torch.arange(8, dtype=torch.int32, device=device), cnt,
                       torch.tensor([3, 0, 7, 3], dtype=torch.int32, device=device)]
            for trial in range(6):
                slots = _rand_slots(rng, 1 + 3 * trial % 16, leaves, ranges[:trial % 5])
                k = len(slots)
                pick = lambda: int(rng.integers(0, k))  # noqa: E731
                aggs = [("sum", pick(), 1, 2, full), ("sum", -1, 0, 2, full),
                        ("minmax", pick(), 2, 2, full, True), ("minmax", pick(), 0, 2, full, False),
                        ("topn", pick(), 1, 3, 2), ("topnf", pick(), 0, 3, 0, 1, 1, 5),
                        ("topnf", pick(), 3, 3, 0, 1, 2, None),
                        ("group", pick(), 1, (0, 1), ((0, 3, -1), (2, 5))),
                        ("group", -1, 2, (1,), ((4, 1, 0, 5),))]
                spec = kernels.FusedSpec(slots, [(pick(), int(rng.integers(0, 4)))
                                                 for _ in range(3)], aggs)
                got = kernels.fused_tree(spec, dmats, masks, tensors)
                want = kernels.fused_tree_plain(spec, dmats, masks, tensors)
                for gi, (g, w) in enumerate(zip(got, want)):
                    same(g, w, f"drain {trial}: output {gi}")
    try:
        kernels.check_fused(kernels.compile_fused(tuple(("row", 0, 0) for _ in range(17))))
    except ValueError:
        pass
    else:
        raise AssertionError("F1 took 17 slots")
    try:
        kernels.check_fused(kernels.compile_fused((("row", 0, 0),)), 33)
    except ValueError:
        pass
    else:
        raise AssertionError("F1 took 33 count edges")
    log(f"kernels: {n} comparisons exact (F1 fused_tree against its plain version, and "
        "whole drains against fused_tree_plain)")
    return err


# -- phase 3: the main path --------------------------------------------------


def _pool_case(rng, S, P, n_rows, device):
    """A block pool int32[P, S, 512] of random words (slot 0 all zero) and
    its slot table int32[n_rows + 1, 64]: random block layouts whose slots
    repeat across rows (a slot recycled by another row), row 1 all zero (a
    row known empty), the last row the all-zero vector the engine gives an
    absent row, and one row using every block (when P > 1)."""
    import torch

    words = rng.integers(0, 1 << 32, (P, S, 512), dtype=np.uint64).astype(np.uint32)
    words[0] = 0
    if P > 1:
        words[1, 0] = 0xFFFFFFFF
        words[1, 1] = 0x80000000
    table = np.zeros((n_rows + 1, 64), dtype=np.int32)
    if P > 1:
        for r in range(n_rows):
            if r == 1:
                continue
            blocks = rng.choice(64, int(rng.integers(1, 64 if r == 2 else 16)), replace=False)
            table[r, blocks] = rng.integers(1, P, len(blocks))
        table[n_rows - 1] = rng.integers(1, P, 64)  # every block
    return (torch.from_numpy(words.view(np.int32)).to(device),
            torch.from_numpy(table).to(device))


def check_minmax_pool(device, seed):
    """K7P (minmax_tree_pool) against both plain versions, Min and Max,
    exactly, at the shapes its design turns on: depths 1, 8 and 63 (the 8-
    and 63-plane tiers: live blocks two at a time, and one at a time), a
    live word of one block (the lone block after the pairs) and of all 64,
    chain and interpreter filters over pool rows,
    stack rows and a range leaf, a dead live word, unrequested shards,
    shards whose filter is empty (every pool word zero there), and ties
    across shards (three shards holding the same values).  Returns max
    |err|."""
    import torch

    from pilosa_tpu_torch.parallel import bsi, kernels

    rng = np.random.default_rng(seed + 29)
    S, P = 40, 9
    pool, table = _pool_case(rng, S, P, 6, device)
    pool[:, 5] = 0  # shard 5: every pool word zero, so a pool filter is empty there
    table[0] = 0
    table[0, 37] = 3  # row 0 live in one block
    dense = _adversarial_stack(rng, 4, S, device)
    dense[:, 5] = 0
    fbst = _bsi_stack(rng, 8, S, device)
    mats = [dense, pool, table, fbst]
    rb = [("rowb", 1, 2, r) for r in range(7)]
    rg = _range_leaf("gt", tuple(range(9)), int(rng.integers(0, 256)), 0, slot=3)
    filters = [rb[0], ("and", rb[0], ("row", 0, 1)), ("or", rb[5], rb[2]),
               ("or", rb[3], ("row", 0, 2)), ("and", rb[2], rg),
               ("andnot", ("or", rb[2], rb[4]), ("and", rb[3], ("row", 0, 0))),
               ("and", rb[1], rb[2])]
    no03 = np.ones(S, np.int32)
    no03[[0, 3]] = 0
    masks = [torch.from_numpy(m).to(device) for m in (
        np.ones(S, np.int32), np.zeros(S, np.int32), (rng.random(S) < 0.5).astype(np.int32),
        no03)]
    err, n = 0, 0
    for depth in (1, 8, 63):
        bst = _bsi_stack(rng, depth, S, device, extra=0)
        bst[:, 7] = bst[:, 6]  # ties: shards 6, 7 and 8 hold the same values
        bst[:, 8] = bst[:, 6]
        full = tuple(range(depth + 1))
        holed = tuple(-1 if i == depth // 2 else i for i in full)
        lives = []
        for t in filters:
            code = kernels.compile_prog(t)
            lives.append(int(kernels.live_blocks(t, mats, device).sum()))
            for mi, m in enumerate(masks):
                planes = holed if mi == 2 else full
                for is_min in (True, False):
                    got = bsi.minmax_tree_pool_cuda(code, mats, m, bst, planes, is_min)
                    for plain in (bsi.minmax_tree_pool_plain, bsi.minmax_tree_plain):
                        want = plain(t, mats, m, bst, planes, is_min)
                        for g, w, part in zip(got, want, ("values", "counts")):
                            torch.cuda.synchronize()
                            err = max(err, _exact(
                                "K7P", g, w, f"{'Min' if is_min else 'Max'} {part} depth "
                                f"{depth} {t} mask {mi} ({plain.__name__})"))
                            n += 1
        assert {1, 64, 0} <= set(lives), lives
        del bst
    log(f"kernels: {n} comparisons exact (K7P minmax_tree_pool against both plain versions: "
        "depths 1, 8, 63, live words of 0, 1 and 64 blocks, empty and unrequested shards, "
        "ties)")
    return {"minmax_tree_pool": err}


def check_pool_leaf(device, seed):
    """The pool leaf ("rowb", csrc/tree_eval.cuh load_pool; K5's staging)
    in every kernel that evaluates a tree, against the plain versions
    (kernels.pool_row's gather), exactly: random slot layouts with slot 0
    blocks, rows all zero, slots shared by two rows, the all-zero vector,
    a pool of one slot; pool leaves alone and mixed with stack rows and
    range leaves; in K1 (chain and interpreter trees), K2 (block words),
    K3 (a src tree), K5 (batches with their tiles staged and not), K6 and
    K7 (filters), K8 (a filter) and F1 (slots and whole drains); masks of
    every shard, none and a ragged set; 12 and 37 shards; two streams.
    K1P (count_tree_pool) on the same trees, sizes and masks, and on
    trees whose live word is 0, against both count_tree_pool_plain and
    count_tree_plain.  K3P (score_rows_pool: the phase-1 scores and src
    counts, the full TopN's totals and trim) and K6P (sum_tree_pool, full
    and holed plane sets) on the same trees, sizes and masks, and on dead
    and full live words, against both their pool plain versions and the
    whole-row ones; K3P at K = 300 (the trim launch) and on two streams
    (the totals scratch).  K7P (minmax_tree_pool, Min and Max, depth tiers
    8 and 16, full and holed plane sets) and K8P (groupn_tree_pool, the register form and the walk) on the same
    trees and sizes, masks of every shard, none, a ragged set and one
    without shard 0, against both their pool plain versions and the
    whole-row ones, and on two streams.  Returns max |err|."""
    import torch

    from pilosa_tpu_torch.parallel import bsi, groupby, kernels, sparse

    rng = np.random.default_rng(seed + 41)
    err = {"rowb": 0, "count_tree_pool": 0, "score_rows_pool": 0, "sum_tree_pool": 0,
           "minmax_tree_pool": 0, "groupn_tree_pool": 0, "count_batch_tree_pool": 0,
           "fused_tree_pool": 0}
    n = 0

    def same(got, want, what, key="rowb"):
        nonlocal n
        torch.cuda.synchronize()
        err[key] = max(err[key], _exact(key, got, want.to(got.device), what))
        n += 1

    def k1p_same(t, code, mats, m, what):
        got = kernels.count_tree_pool(code, mats, m).reshape(1)
        same(got, kernels.count_tree_pool_plain(t, mats, m).reshape(1), f"K1P {what}",
             "count_tree_pool")
        same(got, kernels.count_tree_plain(t, mats, m).reshape(1), f"K1P against K1's plain {what}",
             "count_tree_pool")

    def k3p_same(t, code, mats, m, dense, cand, cnt, what):
        """K3P's phase 1 and full TopN (totals, and trimmed to 3 and K)
        against both plain versions."""
        sc, cn, _ = kernels.score_rows_pool_cuda(code, mats, m, dense, cand, src_counts=True)
        for plain in (kernels.topn_tree_pool_plain, kernels.topn_tree_plain):
            ws, wc = plain(t, mats, m, dense, cand)
            same(sc, ws, f"K3P scores {what} ({plain.__name__})", "score_rows_pool")
            same(cn, wc, f"K3P src counts {what} ({plain.__name__})", "score_rows_pool")
        for thr in (1, 1 << 14):
            for n_out in (None, 3, cand.numel()):
                got = kernels.score_rows_pool_cuda(code, mats, m, dense, cand, scores=False,
                                                   cnt=cnt, thr=thr, n_out=n_out)[2]
                for plain in (kernels.topn_full_tree_pool_plain, kernels.topn_full_tree_plain):
                    want = plain(t, mats, m, dense, cand, cnt, thr, n_out)
                    want = want if n_out is None else torch.stack(want)
                    same(got.reshape(-1), want.reshape(-1),
                         f"K3P TopN thr={thr} n_out={n_out} {what} ({plain.__name__})",
                         "score_rows_pool")

    def k6p_same(t, code, mats, m, bst, planes, what):
        got = bsi.sum_tree_pool_cuda(code, mats, m, bst, planes)
        for plain in (bsi.sum_tree_pool_plain, bsi.sum_tree_plain):
            same(got, plain(t, mats, m, bst, planes), f"K6P {what} ({plain.__name__})",
                 "sum_tree_pool")

    def k7p_same(t, code, mats, m, bst, planes, what):
        """K7P's Min and Max against both plain versions."""
        for is_min in (True, False):
            got = bsi.minmax_tree_pool_cuda(code, mats, m, bst, planes, is_min)
            for plain in (bsi.minmax_tree_pool_plain, bsi.minmax_tree_plain):
                want = plain(t, mats, m, bst, planes, is_min)
                for g, w, part in zip(got, want, ("values", "counts")):
                    same(g, w, f"K7P {'Min' if is_min else 'Max'} {part} {what} "
                         f"({plain.__name__})", "minmax_tree_pool")

    def k8p_same(t, code, mats, m, fields, lists, what):
        """K8P in the form groupn_plan gives the lists, against both plain
        versions."""
        got = groupby.groupn_tree_pool_cuda(code, mats, m, fields, lists)
        for plain in (groupby.groupn_tree_pool_plain, groupby.groupn_tree_plain):
            same(got, plain(t, mats, m, fields, lists), f"K8P {what} ({plain.__name__})",
                 "groupn_tree_pool")

    # K8P's shapes: the register form (4 rows, then 2), the walk (a second
    # field of 3 rows; three fields); rows of -1 among them.
    k8_shapes = [("registers", [[0, 2, 1, -1], [3, 1]]), ("walk", [[0, 2, 1], [3, -1, 0]]),
                 ("walk", [[1, 3, 0], [0, 2, 3], [2, -1]])]

    def k5p_same(progs, mats, bmasks, what, fan=None):
        """K5P over a batch against both plain versions (a fan-out too)."""
        ids = [int(i) for i in rng.integers(0, len(bmasks), len(progs))]
        batch = kernels.compile_batch(progs, ids)
        got = kernels.count_batch_tree_pool_cuda(batch, mats, bmasks, device, fan)
        for plain in (kernels.count_batch_tree_pool_plain, kernels.count_batch_tree_plain):
            same(got, plain(progs, mats, bmasks, ids, device, fan),
                 f"K5P {what} ({plain.__name__})", "count_batch_tree_pool")

    for S, P in ((12, 9), (37, 33), (12, 1)):
        pool, table = _pool_case(rng, S, P, 6, device)
        dense = _adversarial_stack(rng, 4, S, device)
        bst = _bsi_stack(rng, 8, S, device)
        bst16 = _bsi_stack(rng, 16, S, device)
        mats = [dense, pool, table, bst]
        full = tuple(range(9))
        rb = [("rowb", 1, 2, r) for r in range(7)]
        rg = _range_leaf("gt", full, int(rng.integers(0, 256)), 0, slot=3)
        trees = [
            rb[0], ("and", rb[0], ("row", 0, 1)), ("or", rb[2], rb[3], rb[1]),
            ("andnot", rb[5], ("row", 0, 0)), ("xor", rb[0], rb[4], ("row", 0, 2)),
            ("and", rb[6], rb[0]), ("and", ("or", rb[0], ("zero",)), rb[3]),
            ("andnot", ("or", rb[2], ("row", 0, 3)), ("and", rb[4], ("xor", rb[5], rb[0]))),
            ("and", rb[2], rg), ("or", ("andnot", rb[3], rg), ("row", 0, 1)),
        ]
        masks = [torch.from_numpy(m).to(device) for m in (
            np.ones(S, np.int32), np.zeros(S, np.int32), (rng.random(S) < 0.5).astype(np.int32))]
        # A tree of stack rows only, with the pool and its table among the
        # launch's stacks all the same (a batch's lowering holds them).
        dense_t = ("and", ("row", 0, 1), ("row", 0, 2))
        same(kernels.count_tree_dense(kernels.compile_prog(dense_t), mats, masks[0]).reshape(1),
             kernels.count_tree_plain(dense_t, mats, masks[0]).reshape(1), "K1 beside a pool")
        # K1P: every block of a tree without pool leaves is live; a dead
        # live word (an all-zero row, the all-zero vector, a zero subtree
        # under an and) reads nothing and counts 0.
        dead = [("and", rb[1], rb[0]), ("and", ("row", 0, 2), ("and", rb[6], rb[3])),
                ("andnot", ("and", rb[2], ("zero",)), ("row", 0, 1))]
        cand8 = torch.tensor([0, 3, 1, 2, 3, 0, 0, 0], dtype=torch.int32, device=device)
        cnt8 = torch.randint(0, 3 << 15, (8, S), dtype=torch.int32, device=device)
        holed = tuple(-1 if i == 3 else i for i in range(9))
        no0 = (rng.random(S) < 0.6).astype(np.int32)
        no0[0] = 0
        for t in [dense_t] + dead + trees:
            code = kernels.compile_prog(t)
            for m in masks:
                k1p_same(t, code, mats, m, f"{t} S={S} P={P}")
                k3p_same(t, code, mats, m, dense, cand8, cnt8, f"{t} S={S} P={P}")
                k6p_same(t, code, mats, m, bst, full if m is masks[2] else holed,
                         f"{t} S={S} P={P}")
            # K7P and K8P: masks of every shard, none, a ragged set and one
            # without shard 0.
            for m in masks + [torch.from_numpy(no0).to(device)]:
                k7p_same(t, code, mats, m, bst, full if m is masks[2] else holed,
                         f"depth 8 {t} S={S} P={P}")
                for form, lists in k8_shapes:
                    assert groupby.groupn_plan([len(r) for r in lists])[0] == form
                    k8p_same(t, code, mats, m, [dense] * len(lists), lists,
                             f"{form} {lists} {t} S={S} P={P}")
            k7p_same(t, code, mats, masks[2], bst16, tuple(range(17)),
                     f"depth 16 {t} S={S} P={P}")
        # K3P past 256 candidates: the trim is a second launch.
        big = torch.from_numpy(rng.integers(0, 4, 300).astype(np.int32)).to(device)
        big_cnt = torch.randint(0, 3 << 15, (300, S), dtype=torch.int32, device=device)
        for t in (trees[2], trees[8], dead[0]):
            k3p_same(t, kernels.compile_prog(t), mats, masks[2], dense, big, big_cnt,
                     f"K=300 {t} S={S} P={P}")
        for t in trees:
            code = kernels.compile_prog(t)
            kernels.check_prog(code)
            for m in masks:
                same(kernels.count_tree_dense(code, mats, m).reshape(1),
                     kernels.count_tree_plain(t, mats, m).reshape(1), f"K1 {t} S={S} P={P}")
            for what, bits in _block_word_cases(rng, S)[::3]:
                bb = torch.from_numpy(bits.view(np.int64)).to(device)
                same(sparse.count_tree_blocks_cuda(code, mats, bb).reshape(1),
                     sparse.count_tree_blocks_plain(t, mats, bb).reshape(1), f"K2 {t} {what}")
            cand = torch.tensor([0, 3, 1, 2], dtype=torch.int32, device=device)
            m = masks[2]
            sc, cnt, _ = kernels.score_rows_cuda(code, mats, m, dense, cand, src_counts=True)
            ws, wc = kernels.topn_tree_plain(t, mats, m, dense, cand)
            same(sc, ws, f"K3 scores {t}")
            same(cnt, wc, f"K3 src counts {t}")
            same(bsi.sum_tree_cuda(code, mats, m, bst, full),
                 bsi.sum_tree_plain(t, mats, m, bst, full), f"K6 {t}")
            for is_min in (True, False):
                got = bsi.minmax_tree_cuda(code, mats, m, bst, full, is_min)
                want = bsi.minmax_tree_plain(t, mats, m, bst, full, is_min)
                same(got[0], want[0], f"K7 values {t}")
                same(got[1], want[1], f"K7 counts {t}")
            lists = [[0, 2, 1], [3, -1]]
            same(groupby.groupn_tree_cuda(code, mats, m, [dense, dense], lists),
                 groupby.groupn_tree_plain(t, mats, m, [dense, dense], lists), f"K8 {t}")
        # K5: batches of the trees without a range leaf, staged (few leaf
        # rows) and unstaged (past 128 distinct rows), with repeats.
        batch = [t for t in trees if kernels.fits(t)]
        bmasks = np.stack([np.ones(S, bool), np.zeros(S, bool), rng.random(S) < 0.5])
        for progs in (batch, batch * 3, batch + [("or", ("row", 0, k % 4), rb[k % 7])
                                                 for k in range(140)]):
            ids = [int(i) for i in rng.integers(0, 3, len(progs))]
            got = kernels.count_batch_tree_cuda(kernels.compile_batch(progs, ids), mats, bmasks,
                                                device)
            same(got, kernels.count_batch_tree_plain(progs, mats, bmasks, ids, device),
                 f"K5 {len(progs)} queries S={S} P={P}")
        # K5P: batches of the pool trees (dead and full live words among
        # them) at K = 1, 8, 64 and 300, staged; and over a slot table of
        # 150 rows (more than 128 distinct leaf rows: the direct path) at K
        # = 8 and 300; masks of every shard, none and a ragged set.
        pool_batch = [t for t in [dense_t] + dead + trees if kernels.fits(t)]
        k5p_same([trees[4]], mats, bmasks, f"K=1 (a full live word) S={S} P={P}")
        for K in (8, 64, 300):
            progs = [pool_batch[int(i)] for i in rng.integers(0, len(pool_batch), K)]
            k5p_same(progs + [rb[2]], mats, bmasks, f"K={K + 1} staged S={S} P={P}")
        k5p_same(dead, mats, bmasks, f"dead live words S={S} P={P}")
        k5p_same(trees[:3] * 3, mats, bmasks, f"fanned out S={S} P={P}", fan=[8, 0, 3, 3, 5])
        _, wide_table = _pool_case(rng, S, P, 150, device)
        wmats = [dense, pool, wide_table, bst]
        wide = [("and" if k % 3 else "or", ("rowb", 1, 2, k), ("rowb", 1, 2, (k + 77) % 151))
                for k in range(151)] + [("xor", ("rowb", 1, 2, 9), ("row", 0, 2))]
        k5p_same(wide + [wide[int(i)] for i in rng.integers(0, len(wide), 300 - len(wide))],
                 wmats, bmasks, f"K=300 direct S={S} P={P}")
        k5p_same([("or",) + tuple(("rowb", 1, 2, 17 * q + k) for k in range(17)) if q % 2 else
                  ("and", ("or",) + tuple(("rowb", 1, 2, 17 * q + k) for k in range(16)),
                   ("rowb", 1, 2, 17 * q + 16)) for q in range(8)],
                 wmats, bmasks, f"K=8 direct (136 rows) S={S} P={P}")
        # F1P: slot tables over pool rows (mref chains, an xor naming a slot
        # twice, andnot with a pool left side, stack rows beside pool rows,
        # a range leaf, a dead slot and a full one), count edges on gates,
        # every edge kind over a pool slot; a need subset without shard 0
        # (CTA (0, 0) writes the table all the same).
        fslots = (("and", rb[0], ("row", 0, 1)), ("or", ("mref", 0), rb[2]),
                  ("xor", ("mref", 1), rb[4], ("mref", 0), ("mref", 0)),
                  ("andnot", rb[5], ("row", 0, 0)), ("or", ("mref", 2), ("mref", 3), rb[6]),
                  ("and", rb[1], rb[0]), ("andnot", ("mref", 1), rb[3]),
                  ("or", rb[2], ("row", 0, 3)), ("and", rb[2], rg))
        f_masks = [torch.from_numpy(m).to(device) for m in (
            np.ones(S, np.int32), (rng.random(S) < 0.5).astype(np.int32), np.zeros(S, np.int32))]
        cand300 = torch.from_numpy(rng.integers(0, 4, 300).astype(np.int32)).to(device)
        cnt300 = torch.randint(0, 3 << 15, (300, S), dtype=torch.int32, device=device)
        f_tensors = [cand8, cnt8, cand300, cnt300]
        f_aggs = [("sum", 1, 0, 3, full), ("sum", 7, 1, 3, holed), ("sum", 5, 0, 3, full),
                  ("minmax", 3, 1, 3, full, True), ("minmax", 4, 0, 3, full, False),
                  ("topn", 2, 0, 0, 0), ("topnf", 4, 1, 0, 2, 3, 1, 5),
                  ("topnf", 8, 0, 0, 0, 1, 1 << 14, None), ("group", 6, 1, (0,), ((0, 1, 3),)),
                  ("group", 5, 0, (0, 0), ((2, 1), (0, 3)))]
        f_counts = [(0, 0), (1, 1), (2, 0), (4, 1), (5, 0), (6, 1), (7, 2), (8, 0)]
        spec = kernels.FusedSpec(fslots, f_counts, f_aggs)
        code = spec.code()
        assert code.pooled
        need_np = ((rng.random(S) < 0.6) | (f_masks[1].cpu().numpy() != 0)).astype(np.int32)
        need_np[0] = 0
        keep = torch.from_numpy(need_np != 0).to(device)
        gates = [f_masks[m] * torch.from_numpy(need_np).to(device) for _, m in f_counts]
        cslots = [j for j, _ in f_counts]
        for nd in (None, torch.from_numpy(need_np).to(device)):
            counts, (fpool, ftable) = kernels.fused_tree_pool_cuda(
                code, mats, cslots, gates, spec.mat_slots, nd)
            torch.cuda.synchronize()
            fpool, ftable = fpool.clone(), ftable.clone()
            vals = kernels.fused_slots_plain(fslots, mats, (S, 32768), device)
            want = torch.stack([kernels.bitops.popcount_words(vals[j][g != 0]).sum()
                                for j, g in zip(cslots, gates)]).to(torch.int64)
            what = f"S={S} P={P} need={'none' if nd is None else 'subset'}"
            same(counts, want, f"F1P counts {what}", "fused_tree_pool")
            wpool, wtable = kernels.fused_mat_pool_plain(spec, mats, f_masks)
            same(ftable, wtable, f"F1P table {what}", "fused_tree_pool")
            live_slots = torch.unique(wtable[wtable != 0]).long()
            rows = slice(None) if nd is None else keep
            same(fpool[live_slots][:, rows], wpool[live_slots][:, rows],
                 f"F1P pool at the live blocks {what}", "fused_tree_pool")
            same(fpool[0], torch.zeros_like(fpool[0]), f"F1P pool slot 0 {what}",
                 "fused_tree_pool")
        got = kernels.fused_tree(spec, mats, f_masks, f_tensors)
        for plain in (kernels.fused_tree_pool_plain, kernels.fused_tree_plain):
            want = plain(spec, mats, f_masks, f_tensors)
            for i, (g, w) in enumerate(zip(got, want)):
                same(g, w, f"F1P drain output {i} S={S} P={P} ({plain.__name__})",
                     "fused_tree_pool")
        # F1: a slot table over pool, stack and range leaves, count edges
        # and materialized slots read by K6, K7, K3 and K8 edges (F1's own
        # launch, whose slots then read as stack rows).
        slots = (("and", rb[0], ("row", 0, 1)), ("or", ("mref", 0), rb[2]),
                 ("xor", ("mref", 1), rb[4], ("row", 0, 2)), ("andnot", rb[5], rg),
                 ("or", ("mref", 2), ("mref", 3), rb[6]))
        fmasks = masks[:1] + masks[2:]
        cand_idx = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=device)
        cnt = torch.randint(0, 3, (4, S), dtype=torch.int32, device=device)
        spec = kernels.FusedSpec(
            slots, [(0, 0), (1, 1), (2, 0), (4, 1)],
            [("sum", 1, 0, 3, full), ("minmax", 3, 1, 3, full, True),
             ("topn", 2, 0, 0, 0), ("topnf", 4, 1, 0, 0, 1, 1, 2), ("group", 4, 0, (0,), ((0, 1),))])
        code = spec.code()
        counts, fmat = kernels.fused_tree_cuda(code, mats, [j for j, _ in spec.count_edges],
                                               [fmasks[m] for _, m in spec.count_edges],
                                               spec.mat_slots)
        got = [counts] + kernels._agg_outputs(spec, mats, fmat, fmasks, [cand_idx, cnt],
                                              plain=False)
        want = kernels.fused_tree_plain(spec, mats, fmasks, [cand_idx, cnt])
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"F1 drain output {i} S={S} P={P}")
        got = kernels.fused_tree(spec, mats, fmasks, [cand_idx, cnt])
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"F1P drain output {i} S={S} P={P}", "fused_tree_pool")
    # Two streams at once over one pool.
    side = torch.cuda.Stream(device=device)
    t = ("or", rb[2], ("row", 0, 1))
    code = kernels.compile_prog(t)
    outs = []
    torch.cuda.synchronize()
    for i in range(8):
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            outs.append(kernels.count_tree_dense(code, mats, masks[i % 3 if i % 3 != 1 else 0]))
    for i, g in enumerate(outs):
        m = masks[i % 3 if i % 3 != 1 else 0]
        same(g.reshape(1), kernels.count_tree_plain(t, mats, m).reshape(1), "K1 on two streams")
    outs = []
    torch.cuda.synchronize()
    for i in range(8):
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            outs.append(kernels.count_tree_pool(code, mats, masks[i % 3]))
    for i, g in enumerate(outs):
        same(g.reshape(1), kernels.count_tree_pool_plain(t, mats, masks[i % 3]).reshape(1),
             "K1P on two streams", "count_tree_pool")
    # K3P's full TopN on two streams at once: each stream's totals scratch.
    outs = []
    torch.cuda.synchronize()
    for i in range(8):
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            outs.append(kernels.score_rows_pool_cuda(code, mats, masks[i % 3], dense, cand8,
                                                     scores=False, cnt=cnt8, n_out=3)[2])
    for i, g in enumerate(outs):
        want = kernels.topn_full_tree_pool_plain(t, mats, masks[i % 3], dense, cand8, cnt8, 1, 3)
        same(g.reshape(-1), torch.stack(want).reshape(-1), "K3P on two streams",
             "score_rows_pool")
    # F1P and K5P on two streams at once (each stream's pool, each
    # stream's totals scratch), over a pool of 9 slots.
    mats = [mats[0], *_pool_case(rng, 12, 9, 6, device), mats[3]]
    spec = kernels.FusedSpec((("or", rb[2], rb[0]), ("and", ("mref", 0), rb[4]),
                              ("xor", ("mref", 1), rb[3])), [(1, 0), (2, 0)], [])
    code = spec.code()
    spec_m = kernels.FusedSpec(spec.slots, spec.count_edges, [("sum", 2, 0, 3, full),
                                                              ("sum", 1, 0, 3, full)])
    pending = []
    torch.cuda.synchronize()
    for i in range(8):
        g = masks[i % 3]
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            c, (fp, ft) = kernels.fused_tree_pool_cuda(code, mats, [1, 2], [g, g], [1, 2])
            pending.append((g, c, fp.clone(), ft.clone()))
    torch.cuda.synchronize()
    for g, c, fp, ft in pending:
        vals = kernels.fused_slots_plain(spec.slots, mats, (S, 32768), device)
        same(c, torch.stack([kernels.bitops.popcount_words(vals[j][g != 0]).sum()
                             for j in (1, 2)]).to(torch.int64), "F1P on two streams: counts",
             "fused_tree_pool")
        wpool, wtable = kernels.fused_mat_pool_plain(spec_m, mats, [g])
        same(ft, wtable, "F1P on two streams: table", "fused_tree_pool")
        live_slots = torch.unique(wtable[wtable != 0]).long()
        same(fp[live_slots], wpool[live_slots], "F1P on two streams: pool", "fused_tree_pool")
    progs = [t for t in trees if kernels.fits(t)]
    outs = []
    torch.cuda.synchronize()
    for i in range(8):
        ids = [(i + k) % 3 for k in range(len(progs))]
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            outs.append((ids, kernels.count_batch_tree_pool_cuda(
                kernels.compile_batch(progs, ids), mats, bmasks, device)))
    for ids, g in outs:
        same(g, kernels.count_batch_tree_pool_plain(progs, mats, bmasks, ids, device),
             "K5P on two streams", "count_batch_tree_pool")
    # K7P and K8P on two streams at once, over the pool of 9 slots.
    code_t = kernels.compile_prog(t)
    outs = []
    torch.cuda.synchronize()
    for i in range(8):
        m = masks[i % 3]
        with torch.cuda.stream(side if i % 2 else torch.cuda.default_stream(device)):
            outs.append((m, bsi.minmax_tree_pool_cuda(code_t, mats, m, bst, full, i % 4 < 2),
                         groupby.groupn_tree_pool_cuda(code_t, mats, m, [mats[0]] * 2,
                                                       k8_shapes[i % 2][1])))
    torch.cuda.synchronize()
    for i, (m, (v, c), g) in enumerate(outs):
        wv, wc = bsi.minmax_tree_pool_plain(t, mats, m, bst, full, i % 4 < 2)
        same(v, wv, "K7P values on two streams", "minmax_tree_pool")
        same(c, wc, "K7P counts on two streams", "minmax_tree_pool")
        same(g, groupby.groupn_tree_pool_plain(t, mats, m, [mats[0]] * 2, k8_shapes[i % 2][1]),
             "K8P on two streams", "groupn_tree_pool")
    log(f"pool leaf: {n} comparisons exact (rowb in K1, K1P, K2, K3, K3P, K5, K5P, K6, K6P, K7, "
        "K7P, K8, K8P, F1 and F1P against their plain versions)")
    return err


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
    zero_counts(("count_tree_dense", "count_tree_blocks"))
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


def and_popcounts(a, b, threads=8):
    """popcounts(a & b) over uint64[S, W64] words, the shards split over
    ``threads`` threads (numpy's ufuncs release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    if a.ndim < 2 or a.shape[0] < 2 * threads:
        return popcounts(a & b)
    cuts = np.linspace(0, a.shape[0], threads + 1).astype(int)

    def one(i):
        lo, hi = cuts[i], cuts[i + 1]
        return popcounts(a[lo:hi] & (b if b.ndim == 1 else b[lo:hi]))

    with ThreadPoolExecutor(threads) as pool:
        return np.concatenate(list(pool.map(one, range(threads))))


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
        return {r: and_popcounts(w, src) for r, w in self.top.items()}, popcounts(src)

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
    """TopN through Executor.execute with the engine (K3), then one
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
    zero_counts(("score_rows", "topn_trim", "and_popcount_rows"))
    for q, want in queries:
        got = [tuple(p) for p in ex.execute("bench", q).results[0]]
        if got != want:
            raise AssertionError(f"{q}: port {got} != numpy oracle {want}")
        log(f"main path: {q} -> {got}")
    launches = read_counts(("score_rows", "topn_trim"))
    log(f"main path: {len(queries)} TopN queries exact against numpy; launches {launches}")
    if kernels.and_popcount_rows_cuda.launches:
        raise AssertionError("the engine's TopN lanes launched P2")

    # The engine-less executor: every shard's Fragment.top scores its
    # candidates with P2 (both phases of the reference's TopN).
    q = "TopN(top, Row(f=10), n=5)"
    want = o.two_phase(host["f"][10], 5)
    zero_counts(("and_popcount_rows",))
    t0 = time.perf_counter()
    got = [tuple(p) for p in Executor(holder).execute("bench", q).results[0]]
    wall = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"{q} (no engine): port {got} != numpy oracle {want}")
    launches["and_popcount_rows"] = kernels.and_popcount_rows_cuda.launches
    log(f"main path: {q} without an engine over all {len(o.cnt[0])} shards -> {got}, "
        f"exact, in {wall:.3f} s (row mirrors built on first use); P2 launches "
        f"{launches['and_popcount_rows']}")

    # Warm: the same query again, mirrors resident.
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = [tuple(p) for p in Executor(holder).execute("bench", q).results[0]]
        walls.append(time.perf_counter() - t0)
        if got != want:
            raise AssertionError(f"{q} (no engine, warm): port {got} != numpy oracle {want}")
    log(f"main path: warm engine-less {q} wall p50 {statistics.median(walls) * 1e3:.3f} ms "
        f"over {len(walls)} calls ({', '.join(f'{w * 1e3:.3f}' for w in walls)} ms)")
    return launches, (q, want)


# The wide part of the TopN main path: a TopN over as many candidates as
# the fused lane takes (the engine's MAX_TOPN_CANDIDATES).
WIDE_SHARDS = 16  # 16.8M columns
WIDE_ROWS = 4096  # field w: row r holds base row r % WIDE_BASE's words
WIDE_BASE = 512


class WideOracle(TopNOracle):
    """TopNOracle over field w of index wide: every row r holds the words
    of base row r % len(base), so the counts and scores of the base rows
    serve all of w's rows (the fused lane's semantics, fused())."""

    def __init__(self, base, n_rows):
        self.base = base
        self.rows = list(range(n_rows))
        self.top = dict.fromkeys(self.rows)
        counts = [popcounts(b) for b in base]
        self.cnt = {r: counts[r % len(base)] for r in self.rows}

    def scores(self, src):
        sc = [popcounts(b & src) for b in self.base]
        return {r: sc[r % len(self.base)] for r in self.rows}, popcounts(src)


def build_wide(holder, n_shards, seed):
    """Index wide: field src of 8 dense random rows, field w of WIDE_ROWS
    rows whose words repeat WIDE_BASE base rows of rand & rand & rand, so
    every total ties with 7 others and the tie order decides every rank.
    The fragments share the base rows' arrays (nothing writes this index).
    Returns (src rows, base rows), uint64[S, W64] each."""
    from pilosa_tpu_torch.core.view import VIEW_STANDARD

    rng = np.random.default_rng(seed + 29)
    idx = holder.create_index("wide")
    src = [rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64) for _ in range(8)]
    base = []
    for _ in range(WIDE_BASE):
        b = rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64)
        b &= rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64)
        b &= rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64)
        base.append(b)
    for name, n_rows, words in (("src", 8, src), ("w", WIDE_ROWS, base)):
        view = idx.create_field(name).view_if_not_exists(VIEW_STANDARD)
        for sh in range(n_shards):
            frag = view.fragment_if_not_exists(sh)
            for r in range(n_rows):
                frag.load_row_words(r, words[r % len(words)][sh])
            frag.cache.invalidate()  # once after the bulk load
    return src, base


def wide_queries(src, base):
    """(PQL, expected pairs) of the wide TopN part."""
    o = WideOracle(base, WIDE_ROWS)
    # Near the median per-shard score (2^20 / 8 / 2): gates about half.
    thr = 65600
    return [
        ("TopN(w, Row(src=1), n=5)", o.fused(src[1], 5)),
        ("TopN(w, Row(src=2), n=100)", o.fused(src[2], 100)),
        ("TopN(w, Intersect(Row(src=3), Row(src=4)), n=5)", o.fused(src[3] & src[4], 5)),
        (f"TopN(w, Row(src=5), n={WIDE_ROWS})", o.fused(src[5], WIDE_ROWS)),
        (f"TopN(w, Row(src=6), n=5, threshold={thr})", o.fused(src[6], 5, thr=thr)),
    ]


def run_wide_topn(device, holder, engine, ex, seed, n_shards=WIDE_SHARDS):
    """The wide part of the TopN main path: index wide (build_wide), each
    query of wide_queries through Executor.execute against the numpy
    oracle.  Every one must take the fused lane: one K3 call trimming the
    4096 totals (score_rows_trim_kernel after K3), no P2 launch, no host
    fallback.  The
    counters are zeroed just before and read just after.  Returns the K3
    launches and the part's numbers."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    t0 = time.perf_counter()
    src, base = build_wide(holder, n_shards, seed)
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = engine.field_stack("wide", "w", "standard")
    if device.type == "cuda":
        torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    log(f"main path: wide: data made in {made:.3f} s ({n_shards} shards, {WIDE_ROWS} rows of w "
        f"over {WIDE_BASE} base rows); stack w {tuple(st.matrix.shape)} "
        f"({st.matrix.numel() * 4 / 1e9:.3f} GB) built and uploaded in {stack_s:.3f} s")
    t0 = time.perf_counter()
    queries = wide_queries(src, base)
    oracle_s = time.perf_counter() - t0
    fallbacks = ex.host_fallbacks
    zero_counts(("score_rows", "topn_trim", "and_popcount_rows"))
    lat = []
    for q, want in queries:
        t0 = time.perf_counter()
        got = [tuple(p) for p in ex.execute("wide", q).results[0]]
        lat.append((time.perf_counter() - t0) * 1e3)
        if got != want:
            raise AssertionError(f"{q}: port {got[:8]}... != numpy oracle {want[:8]}... "
                                 f"({len(got)} and {len(want)} pairs)")
        log(f"main path: wide: {q} -> {len(got)} pairs, first {got[:3]}, exact")
    launches = read_counts(("score_rows", "topn_trim"))
    p2 = kernels.and_popcount_rows_cuda.launches
    log(f"main path: wide: {len(queries)} TopN queries exact against numpy (oracle "
        f"{oracle_s:.3f} s); launches {launches}, P2 launches {p2}, host fallbacks "
        f"{ex.host_fallbacks - fallbacks}")
    if device.type == "cuda" and launches != {"score_rows": len(queries),
                                              "topn_trim": len(queries)}:
        raise AssertionError(f"wide TopN: {launches} for {len(queries)} queries, so some "
                             "query left the fused lane or skipped the trim")
    if p2 or ex.host_fallbacks != fallbacks:
        raise AssertionError("wide TopN took the engine-less or host lane")
    out = {"made_s": made, "stack_s": stack_s, "oracle_s": oracle_s, "query_ms": lat}
    if device.type == "cuda":
        out.update(time_wide_k3(engine))
    return launches, out


def time_wide_k3(engine):
    """K3 at the wide shape (4096 candidates over every shard of wide, the
    src Row(src=1)): its device time copying the totals out, and what the
    trim adds to it at n_out 5 and 4096, beside the bound."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel import kernels

    sync = torch.cuda.synchronize
    canonical = engine.canonical_shards("wide")
    stack = engine.field_stack("wide", "w", "standard")
    entry = engine._topn_candidates("wide", "w", stack)
    mask = engine._mask_words(canonical, canonical)
    prog, lw = engine._lower_src("wide", pql.parse("Row(src=1)").calls[0], canonical)
    code = kernels.compile_prog(prog)
    K, S, W = entry.cand_idx.shape[0], len(canonical), 32768

    def k3(n_out=None):
        return kernels.score_rows_cuda(code, lw.mats, mask, stack.matrix, entry.cand_idx,
                                       scores=False, cnt=entry.dev_cnt, thr=1, n_out=n_out)[2]

    base = measured(k3, "score_rows_kernel", sync)
    bound = ((K + 1) * S * W * 4 + K * S * 4 + K * 8) / HBM_BYTES_PER_S * 1e3
    out = {"k3_wide": {**base, "bound_ms": bound, "K": K, "S": S}}
    for n_out in (5, K):
        out[f"trim_added_wide_{n_out}"] = trim_added(k3, lambda n_out=n_out: k3(n_out), sync)
    totals = k3()
    out["torch_sort_wide_ms"] = p50_ms(lambda: torch.sort(totals, descending=True, stable=True),
                                       15, sync)
    _times_line(f"K3 at the wide shape, K={K}, S={S}, totals copied out", base, bound, float("nan"),
                "; trim added: " + ", ".join(
                    f"n_out={n} {out[f'trim_added_wide_{n}']['device_ms']:.4f} ms"
                    for n in (5, K)) + f"; torch.sort {out['torch_sort_wide_ms']:.4f} ms")
    return out


def engine_less_kernels(holder, q, want):
    """The card's kernel list of one warm engine-less TopN, from
    torch.profiler: every launch must be P2 (no gather, no fill)."""
    from pilosa_tpu_torch.executor.executor import Executor

    got = []

    def run():
        got.clear()
        got.extend(tuple(p) for p in Executor(holder).execute("bench", q).results[0])

    seen = on_card(run, lambda seen: any("and_popcount_rows_kernel" in k for k in seen))
    if got != want:
        raise AssertionError(f"{q} (no engine, profiled): port {got} != numpy oracle {want}")
    log("main path: kernels of one warm engine-less TopN (torch.profiler): "
        + json.dumps(per_launch(seen)))
    stray = [k for k in seen if not k.startswith("Memcpy") and "and_popcount_rows_kernel" not in k]
    if stray:
        raise AssertionError(f"engine-less TopN launched kernels other than P2: {stray}")


def engine_topn_kernels(ex, q, want):
    """The card's work for one warm engine TopN, from torch.profiler: one
    K3 launch (its last block trims) and one copy back, nothing else: no
    fill, no trim launch."""
    got = []
    want_seen = {"score_rows_kernel": 1, "Memcpy DtoH": 1}

    def tally(seen):
        counts = {}
        for k, (launches, _) in seen.items():
            tag = next((w for w in want_seen if w in k), k)
            counts[tag] = counts.get(tag, 0) + launches
        return counts

    def run():
        got.clear()
        got.extend(tuple(p) for p in ex.execute("bench", q).results[0])

    with memo_off(ex.engine):  # a warm repeat would be a memo hit: no launch
        seen = on_card(run, lambda seen: tally(seen) == want_seen)
    if got != want:
        raise AssertionError(f"{q} (profiled): port {got} != numpy oracle {want}")
    log(f"main path: kernels of one warm engine {q} (torch.profiler): " + json.dumps(per_launch(seen)))
    counts = tally(seen)
    if counts != want_seen:
        raise AssertionError(f"a warm engine TopN put {counts} on the card, not {want_seen}")


# -- phase 4: times ----------------------------------------------------------


def _entry(name, source, replaces, launches, err, times, plain, byts, ops, library):
    """One {"kernels": [...]} entry; the bound is the larger of the bytes
    over the memory rate and the operations (an integer count, or integer
    operations and population counts) over the card's rates."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, op_seconds(ops)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times["ms"],
        "device_ms": times["device_ms"], "host_us": times["host_us"], "plain_ms": plain,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library,
    }


def _times_line(tag, t, bound, plain, extra=""):
    log(f"times: {tag} ms {t['ms']:.4f} (CUDA events around the wrapper), "
        f"device {t['device_ms']:.4f} ms "
        f"(torch.profiler), host {t['host_us']:.1f} us per call; bound {bound:.4f} ms, "
        f"plain {plain:.3f} ms{extra}")


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
    t1 = measured(lambda: kernels.count_tree_dense(codes[next(it) % 12], lw.mats, mask),
                  "count_tree_dense_kernel", sync)
    plain1 = p50_ms(lambda: kernels.count_tree_plain(progs[next(it) % 12], lw.mats, mask), 5, sync, batch=2)
    # Least time: each leaf row's words of the requested shards read once,
    # plus the mask and the result; about four integer ops per word.
    words = 2 * S * 32768
    out.append(_entry("count_tree_dense", "pilosa_tpu_torch/csrc/count_tree_dense.cu",
                      "pilosa_tpu/parallel/kernels.py:242", launches["count_tree_dense"],
                      err["count_tree_dense"], t1, plain1, words * 4 + S * 4 + 8, words * 4, None))
    _times_line("K1 count_tree_dense", t1, out[-1]["bound_ms"], plain1)

    # K2 at the sparse main path's shape: the 12 pairs of s, each with the
    # planner's block words on the card.
    lw2 = _Lowering(engine, canonical)
    plans = []
    for k in range(12):
        c = pql.parse(f"Intersect(Row(s={10 + 2 * k}), Row(s={11 + 2 * k}))").calls[0]
        prog = engine._lower("bench", c, lw2)
        blk_bits, _ = engine._sparse_plan(prog, lw2, canonical, canonical)
        plans.append((prog, kernels.compile_prog(prog), torch.from_numpy(blk_bits).to(device),
                      int(popcounts(blk_bits.view(np.uint64)))))
    for prog, code, bb, _ in plans:  # held against plain at this shape
        got = int(sparse.count_tree_blocks_cuda(code, lw2.mats, bb))
        e = abs(got - int(sparse.count_tree_blocks_plain(prog, lw2.mats, bb)))
        err["count_tree_blocks"] = max(err["count_tree_blocks"], e)
        if e:
            raise AssertionError(f"K2 at the main-path shape: {prog} off by {e}")
    for _ in range(5):
        sparse.count_tree_blocks_cuda(plans[0][1], lw2.mats, plans[0][2])
    sync()

    def k2_call():
        _, code, bb, _ = plans[next(it) % 12]
        return sparse.count_tree_blocks_cuda(code, lw2.mats, bb)

    def k2_plain():
        prog, _, bb, _ = plans[next(it) % 12]
        return sparse.count_tree_blocks_plain(prog, lw2.mats, bb)

    t2 = measured(k2_call, "count_tree_blocks_kernel", sync)
    plain2 = p50_ms(k2_plain, 5, sync, batch=2)
    # Least work per plan: each marked 2 KiB block of both leaves read
    # once, plus the S block words and the result; the median plan of 12.
    blocks = statistics.median(n for _, _, _, n in plans)
    out.append(_entry("count_tree_blocks", "pilosa_tpu_torch/csrc/count_tree_blocks.cu",
                      "pilosa_tpu/parallel/sparse.py:164", launches["count_tree_blocks"],
                      err["count_tree_blocks"], t2, plain2,
                      2 * blocks * 2048 + S * 8 + 8, 2 * blocks * 512 * 4, None))
    _times_line("K2 count_tree_blocks", t2, out[-1]["bound_ms"], plain2,
                f"; a median {blocks} blocks per leaf")

    # End to end: Executor.execute of the 12 north-star Counts, host clock
    # around a synchronous answer (parse cache warm, stacks resident).
    with memo_off(engine):  # the memo would answer the repeats
        for field in ("f", "s"):
            log(f"times: end-to-end Count(Intersect) on {field} p50 "
                f"{count_p50_ms(ex, field):.4f} ms over 48 queries")
    return out


def count_p50_ms(ex, field):
    """p50 of Executor.execute over the 12 north-star Counts on a field,
    four times each, host clock around a synchronous answer."""
    qs = [pql_of(field, "and", (10 + 2 * k, 11 + 2 * k)) for k in range(12)]
    lat = []
    for _ in range(4):
        for q in qs:
            t0 = time.perf_counter()
            ex.execute("bench", q)
            lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def topn_p50_ms(ex):
    """p50 of Executor.execute of TopN(top, Row(f=r), n=5) over 12 src
    rows, three times each, host clock around a synchronous answer."""
    qs = [f"TopN(top, Row(f={r}), n=5)" for r in range(10, 22)]
    lat = []
    for _ in range(3):
        for q in qs:
            t0 = time.perf_counter()
            ex.execute("bench", q)
            lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def trim_added(base, fused, sync):
    """What the trim adds to a K3 call: ``fused`` (K3 trimming to n_out,
    past 256 candidates with score_rows_trim_kernel after it) minus ``base`` (K3
    copying the totals out), device time per call over both kernels, each
    measured twice, in turns (base, fused, fused, base), as {"ms",
    "device_ms", "host_us"}."""
    runs = [measured(fn, "score_rows", sync, per_call=True) for fn in (base, fused, fused, base)]
    return {k: (runs[1][k] + runs[2][k] - runs[0][k] - runs[3][k]) / 2 for k in runs[0]}


def time_topn(engine, ex, holder, device, err, launches):
    """K3 (with the trim in its last block) and P2 at the TopN main path's
    shapes (P2 also at scripts/pallas_vs_xla.py's), each held against its
    plain version there first, and the end-to-end TopN p50."""
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
    t3 = measured(k3, "score_rows_kernel", sync)
    plain3 = p50_ms(k3_plain, 3, sync, batch=1)
    # Least work: each candidate row and the src row of every requested
    # shard read once, the counts, mask and indices read, the totals
    # written; an AND, a popcount and an add per candidate word.
    bytes3 = (K + 1) * S * W * 4 + K * S * 4 + S * 4 + K * 4 + K * 8
    out = [_entry("score_rows", "pilosa_tpu_torch/csrc/score_rows.cu",
                  "pilosa_tpu/parallel/kernels.py:346", launches["score_rows"],
                  err["score_rows"], t3, plain3, bytes3, (2 * K * S * W, K * S * W), None)]
    _times_line(f"K3 score_rows at K={K}, S={S}", t3, out[-1]["bound_ms"], plain3)

    # The trim runs in K3's last block (past 256 candidates in
    # score_rows_trim_kernel after K3): what it adds to a full-TopN call is
    # K3 trimming to n_out minus K3 copying the totals out, at the main
    # path's K, at 1000 and at the most candidates the totals take, with
    # n_out 5 and K; beside the plain trim and torch.sort.
    for prog, code, mats in lowered[:2]:  # held against plain at this shape
        _, _, got = kernels.score_rows_cuda(code, mats, mask, stack.matrix, entry.cand_idx,
                                            scores=False, cnt=entry.dev_cnt, thr=1, n_out=5)
        want = kernels.topn_full_tree_plain(prog, mats, mask, stack.matrix, entry.cand_idx,
                                            entry.dev_cnt, 1, 5)
        err["topn_trim"] = max(err["topn_trim"], _exact("K3 trim", got, torch.stack(want),
                                                        "at the main-path shape"))

    def k3_trim(n_out):
        _, code, mats = lowered[next(it) % len(lowered)]
        return kernels.score_rows_cuda(code, mats, mask, stack.matrix, entry.cand_idx,
                                       scores=False, cnt=entry.dev_cnt, thr=1, n_out=n_out)[2]

    added, plain_at, lib_at = {}, {}, {}
    for n_out in (5, K):
        added[f"{K}/{n_out}"] = trim_added(k3, lambda n_out=n_out: k3_trim(n_out), sync)
    totals = k3()
    plain_at[str(K)] = p50_ms(lambda: kernels.topn_trim_plain(totals, 5), 5, sync)
    # The one PyTorch call with the same order: a stable descending sort
    # (its first n_out entries); timed as a yardstick, never used.
    lib_at[str(K)] = p50_ms(lambda: torch.sort(totals, descending=True, stable=True), 15, sync)
    gen = torch.Generator(device=device).manual_seed(4096)
    S_M, R_M = 8, 16
    mat_m = torch.randint(-2 ** 31, 2 ** 31 - 1, (R_M, S_M, W), dtype=torch.int32, device=device,
                          generator=gen)
    src_m = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, S_M, W), dtype=torch.int32, device=device,
                          generator=gen)
    idx_all = torch.randint(0, R_M, (kernels.TOTALS_MAX,), dtype=torch.int32, device=device,
                            generator=gen)
    cnt_all = torch.randint(0, 1 << 20, (kernels.TOTALS_MAX, S_M), dtype=torch.int32,
                            device=device, generator=gen)
    mask_m = torch.ones(S_M, dtype=torch.int32, device=device)
    code_m = kernels.compile_prog(("row", 0, 0))
    for K_M in (1000, kernels.TOTALS_MAX):
        idx_m, cnt_m = idx_all[:K_M], cnt_all[:K_M]

        def k3_m(n_out=None, idx_m=idx_m, cnt_m=cnt_m):
            return kernels.score_rows_cuda(code_m, [src_m], mask_m, mat_m, idx_m, scores=False,
                                           cnt=cnt_m, n_out=n_out)[2]

        for n_out in (5, K_M):
            want = kernels.topn_full_tree_plain(("row", 0, 0), [src_m], mask_m, mat_m, idx_m,
                                                cnt_m, 1, n_out)
            err["topn_trim"] = max(err["topn_trim"], _exact(
                "K3 trim", k3_m(n_out), torch.stack(want), f"at K={K_M}, n_out={n_out}"))
            added[f"{K_M}/{n_out}"] = trim_added(k3_m, lambda n_out=n_out: k3_m(n_out), sync)
        totals_m = k3_m()
        plain_at[str(K_M)] = p50_ms(lambda: kernels.topn_trim_plain(totals_m, 5), 5, sync)
        lib_at[str(K_M)] = p50_ms(lambda: torch.sort(totals_m, descending=True, stable=True),
                                  15, sync)
    del mat_m
    # Least work: the K totals read and the n_out pairs written; the
    # K * log2(K) comparisons of a comparison sort, far below the card's rate.
    out.append(_entry("topn_trim", "pilosa_tpu_torch/csrc/score_rows.cu",
                      "pilosa_tpu/parallel/kernels.py:382", launches["topn_trim"],
                      err["topn_trim"], added[f"{K}/5"], plain_at[str(K)], K * 8 + 5 * 8,
                      K * max(1, (K - 1).bit_length()), lib_at[str(K)]))
    out[-1]["runs_in"] = ("score_rows (K3): the last block of its full-TopN launch, past 256 "
                          "candidates score_rows_trim_kernel after it")
    out[-1]["added_device_ms"] = {k: v["device_ms"] for k, v in added.items()}
    out[-1]["plain_ms_at"] = plain_at
    out[-1]["library_ms_at"] = lib_at
    for key, v in added.items():
        k, n_out = (int(x) for x in key.split("/"))
        _times_line(f"trim at K={k}, n_out={n_out}: added to K3", v,
                    (k * 8 + n_out * 8) / HBM_BYTES_PER_S * 1e3, plain_at[str(k)],
                    f"; torch.sort {lib_at[str(k)]:.4f} ms")

    # P2 at the main path's shape: shard 0's top fragment mirror, its
    # candidates named by index in the ranked cache's order, against the
    # src row's segment (what Fragment.top scores per shard); then at the
    # script's own shapes, every row in order.
    frag = holder.fragment("bench", "top", "standard", 0)
    mat, idx = frag.device_matrix()
    main_rows = [idx[r] for r, _ in frag.cache.top() if r in idx]
    row = holder.fragment("bench", "f", "standard", 0).device_row(10)
    shapes = [(mat, row, main_rows)]
    prng = torch.Generator(device=device).manual_seed(2)
    for n_rows in (64, 512, 2048, 8192):
        m = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_rows, W), dtype=torch.int32,
                          device=device, generator=prng)
        shapes.append((m, m[n_rows // 2].clone(), None))
    p2 = []
    for m, r, rows in shapes:
        e = _exact("P2", kernels.and_popcount_rows_cuda(m, r, rows),
                   bitops.popcount_and_rows_plain(m, r, rows), f"R={m.shape[0]}")
        err["and_popcount_rows"] = max(err["and_popcount_rows"], e)
        t = measured(lambda: kernels.and_popcount_rows_cuda(m, r, rows), "and_popcount_rows_kernel", sync)
        plain = p50_ms(lambda: bitops.popcount_and_rows_plain(m, r, rows), 5, sync, batch=2)
        R = m.shape[0] if rows is None else len(rows)
        byts, ops = R * W * 4 + W * 4 + R * 4, (2 * R * W, R * W)
        bound = least_ms(byts, ops)
        p2.append((R, t, plain, byts, ops))
        _times_line(f"P2 and_popcount_rows at [{R}, {W}]" + (" by index" if rows else ""),
                    t, bound, plain, f"; {bound / t['device_ms'] * 100:.1f}% of the bound")
    R, t, plain, byts, ops = p2[0]
    out.append(_entry("and_popcount_rows", "pilosa_tpu_torch/csrc/and_popcount_rows.cu",
                      "scripts/pallas_vs_xla.py:56", launches["and_popcount_rows"],
                      err["and_popcount_rows"], t, plain, byts, ops, None))

    # End to end: Executor.execute of TopN(top, Row(f=r), n=5) over the 12
    # src rows, host clock around a synchronous answer.
    with memo_off(engine):  # a repeated TopN is a memo hit since the aggregate lane
        log(f"times: end-to-end TopN(top, Row(f=r), n=5) p50 {topn_p50_ms(ex):.4f} ms "
            "over 36 queries")
    return out


# -- phase 4 and the serve phase: K5 count_batch_tree ------------------------


@contextlib.contextmanager
def memo_off(engine):
    """The engine's result memo off for the block (a checkout from before
    the memo has none): timing loops repeat their queries, and a memo hit
    would time the memo, not the path."""
    memo = getattr(engine, "result_memo", None)
    old = None if memo is None else memo.maxsize
    if memo is not None:
        memo.maxsize = 0
    try:
        yield
    finally:
        if memo is not None:
            memo.maxsize = old


@contextlib.contextmanager
def repairs_off(engine):
    """The engine's repair layer suspended for the block (a checkout from
    before it has none): a check of the dispatch path after a write must
    reach it, where a repair would answer from the write's delta."""
    rep = getattr(engine, "repairs", None)
    with rep.suspended() if rep is not None else contextlib.nullcontext():
        yield


def batch_bound(progs, mats, masks, mask_ids, S):
    """(bytes, (integer ops, popcounts)) K5's least work needs for one
    batch: each distinct leaf row's words of the shards some query reading
    it requests read once, the packed upload (leaf addresses, programs,
    masks, range records, planes, groups and walk forms) read and the
    int64 answers written; per query and word its combines and an add, and
    a popcount; per distinct range leaf and word of the shards its queries
    request, one three-input logic operation per plane word of its walk
    (two for BETWEEN's double walk; its planes are leaf rows, read once
    like any other)."""
    from pilosa_tpu_torch.parallel import kernels

    batch = kernels.compile_batch(progs, mask_ids)

    def planes_of(r):
        kd, off = int(batch.ranges[r, 2]), int(batch.ranges[r, 3])
        return [int(p) for p in batch.planes[off: off + (kd >> 8) + 1] if p >= 0]

    req, rreq = {}, {}
    for k, (off, n_ops, mid, _) in enumerate(batch.qinfo.tolist()):
        for code in batch.ops[off: off + n_ops].tolist():
            if code & 0xFF == kernels.OP_LEAF:
                req.setdefault(code >> 8, set()).add(mid)
            elif code & 0xFF == kernels.OP_RANGE:
                rreq.setdefault(code >> 8, set()).add(mid)
                for p in planes_of(code >> 8):
                    req.setdefault(p, set()).add(mid)
    words = mats[0].shape[2] if mats else 32768

    def shards(mids):
        return int(np.any(masks[sorted(mids)], axis=0).sum())

    row_bytes = sum(shards(m) for m in req.values()) * words * 4
    upload = (len(batch.leaves) * 8 + batch.qinfo.nbytes + batch.ops.nbytes
              + kernels.mask_bits(masks).nbytes + batch.ranges.nbytes + batch.planes.nbytes
              + batch.groups.nbytes + batch.walks.nbytes)
    n_int = n_popc = 0
    for off, n_ops, mid, _ in batch.qinfo.tolist():
        codes = batch.ops[off: off + n_ops].tolist()
        leaves = sum(1 for c in codes if c & 0xFF in (kernels.OP_LEAF, kernels.OP_ZERO,
                                                      kernels.OP_RANGE))
        n_int += (n_ops - leaves + 1) * int(masks[mid].sum()) * words
        n_popc += int(masks[mid].sum()) * words
    between = kernels.bsi_ops.RANGE_KINDS.index("between")
    for r, mids in rreq.items():
        steps = 2 if int(batch.ranges[r, 2]) & 0xFF == between else 1
        n_int += steps * len(planes_of(r)) * shards(mids) * words
    return row_bytes + upload + len(progs) * 8, (n_int, n_popc)


def f_batch(engine, K, seed):
    """K distinct two-row Count(Intersect) trees on f (of its 276 row
    pairs, shuffled from ``seed``), lowered: (progs, mats, canonical)."""
    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel.engine import _Lowering

    rows = list(F_ROWS)
    pairs = [(a, b) for i, a in enumerate(rows) for b in rows[i + 1:]]
    order = np.random.default_rng(seed).permutation(len(pairs))[:K]
    canonical = engine.canonical_shards("bench")
    lw = _Lowering(engine, canonical)
    progs = [engine._lower("bench", pql.parse(
        "Intersect(Row(f=%d), Row(f=%d))" % pairs[i]).calls[0], lw) for i in order]
    return progs, lw.mats, canonical


def k1_launches_ms(engine, progs, mats, canonical, want, windows=3):
    """The device time of the same trees through K1, one launch each on
    the same stack (torch.profiler, the mean launch over ``windows``
    passes of all of them, times their count), after K1's answers are held
    against ``want``.  Each window starts with one more launch than it
    counts: the profiler can lose a window's first record."""
    from pilosa_tpu_torch.parallel import kernels

    codes = [kernels.compile_prog(p) for p in progs]
    mask = engine._mask_words(canonical, canonical)
    got = [int(kernels.count_tree_dense(c, mats, mask)) for c in codes]
    if got != want:
        raise AssertionError(f"K1 over K5's trees: {got} != K5's {want}")
    def k1_count(seen):
        return sum(n for k, (n, _) in seen.items() if "count_tree_dense_kernel" in k)

    n_want = windows * len(codes)
    seen = on_card(lambda: [kernels.count_tree_dense(c, mats, mask)
                            for c in codes[:1] + codes * windows],
                   lambda seen: n_want <= k1_count(seen) <= n_want + 1)
    hits = [v for k, v in seen.items() if "count_tree_dense_kernel" in k]
    n_seen = sum(n for n, _ in hits)
    if not n_want <= n_seen <= n_want + 1:
        raise AssertionError(f"torch.profiler saw {hits} K1 launches, not {n_want} or {n_want + 1}")
    return sum(t for _, t in hits) / n_seen * len(codes)


def time_batch_f(engine, device, err, seed):
    """K5 at K = 8, 64 and 256 distinct two-row trees on f, every shard
    requested: held exactly against its plain version there first, then
    ms / device_ms / host_us, the bound, the plain p50 (K = 8, 64) and the
    device time of the same K trees as K launches of K1.  Returns {K:
    row}."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    sync = torch.cuda.synchronize
    rows = {}
    for K in (8, 64, 256):
        progs, mats, canonical = f_batch(engine, K, seed)
        S = len(canonical)
        masks = np.ones((1, S), dtype=bool)
        ids = [0] * K

        def call(progs=progs, mats=mats, masks=masks, ids=ids):
            return kernels.count_batch_tree(progs, mats, masks, ids, device)

        got = call()
        want = kernels.count_batch_tree_plain(progs, mats, masks, ids, device)
        err["count_batch_tree"] = max(err["count_batch_tree"],
                                      _exact("K5", got, want, f"at K={K} on f"))
        for _ in range(3):
            call()
        sync()
        t = measured(call, "count_batch_tree_kernel", sync)
        plain = (p50_ms(lambda: kernels.count_batch_tree_plain(progs, mats, masks, ids, device),
                        3, sync, batch=1) if K <= 64 else None)
        byts, ops = batch_bound(progs, mats, masks, ids, S)
        bound = least_ms(byts, ops)
        distinct = len(kernels.compile_batch(progs, ids).leaves)
        k1_ms = k1_launches_ms(engine, progs, mats, canonical, got.tolist())
        rows[K] = {"times": t, "plain_ms": plain, "bytes": byts, "ops": ops, "bound_ms": bound,
                   "distinct_leaves": distinct, "k1_launches_device_ms": k1_ms}
        _times_line(f"K5 count_batch_tree at K={K} on f ({distinct} distinct rows, S={S})", t,
                    bound, plain if plain is not None else float("nan"),
                    f"; the same {K} trees as {K} K1 launches: {k1_ms:.4f} ms of device time "
                    "(torch.profiler)")
    return rows


def time_eval_tree(engine, device, err):
    """K10 at the mesh phase's shapes, Intersect(Row(f=10), Row(f=22)) on
    the main engine's f stack: over all 960 shards in one process (the
    engine's own lowering) and over a rank's block of 480 (the two rows'
    first 480 shards, copied out), each exact against eval_tree_plain and
    against one torch.bitwise_and(a, b, out=o) over the same rows (the
    library call that computes the same words), timed beside its bound:
    the two leaf rows read and the words written, every shard.  Returns
    {S: (times, plain_ms, library_ms, bytes, operations)}."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel import kernels
    from pilosa_tpu_torch.parallel.engine import _Lowering

    sync = torch.cuda.synchronize
    canonical = engine.canonical_shards("bench")
    lw = _Lowering(engine, canonical)
    prog = engine._lower("bench", pql.parse("Intersect(Row(f=10), Row(f=22))").calls[0], lw)
    mat = lw.mats[0]
    r10, r22 = lw.stacks[0].row_index[10], lw.stacks[0].row_index[22]
    out = {}
    for S in (len(canonical), len(canonical) // 2):
        if S == len(canonical):
            mats, p = lw.mats, prog
        else:
            mats = [torch.stack([mat[r10, :S], mat[r22, :S]]).contiguous()]
            p = ("and", ("row", 0, 0), ("row", 0, 1))
        a, b = (mats[0][r10], mats[0][r22]) if S == len(canonical) else (mats[0][0], mats[0][1])
        mask = torch.ones(S, dtype=torch.int32, device=device)
        got = kernels.eval_tree(p, mats, mask)
        lib = torch.empty_like(a)
        torch.bitwise_and(a, b, out=lib)
        want = kernels.eval_tree_plain(p, mats, mask)
        sync()
        bad = int((got != want).sum()) + int((got != lib).sum())
        err["eval_tree"] = max(err.get("eval_tree", 0), bad)
        if bad:
            raise AssertionError(f"K10 over {S} shards: {bad} words differ from its plain "
                                 "version or torch.bitwise_and")
        del got, want
        byts, ops = 3 * S * 32768 * 4, S * 32768
        t = measured(lambda: kernels.eval_tree(p, mats, mask), "eval_tree_kernel", sync,
                     bound_ms=least_ms(byts, ops))
        plain = p50_ms(lambda: kernels.eval_tree_plain(p, mats, mask), 5, sync)
        library = p50_ms(lambda: torch.bitwise_and(a, b, out=lib), 15, sync)
        _times_line(f"K10 eval_tree over {S} shards", t, least_ms(byts, ops), plain,
                    f", torch.bitwise_and {library:.4f} ms")
        out[S] = (t, plain, library, byts, ops)
        del mats, lib
    return out


def time_trim_alone(device):
    """K3's trim launched alone (the mesh's TopN after the all-reduce) on
    drawn totals at K = 16 (the mesh phase's TopN over top) and 4096, n_out
    5: timed beside the plain version and one torch.topk(totals, 5) (the
    library call; its tie order is not guaranteed).  Its bound: the
    totals read and the pairs written, or the bitonic sort's compare and
    select per key and step.  Returns {K: (times, plain_ms, library_ms,
    bytes, operations)}."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    sync = torch.cuda.synchronize
    rng = np.random.default_rng(31)
    out = {}
    for K in (16, 4096):
        totals = torch.from_numpy(rng.integers(0, 1 << 30, K)).to(device)
        steps = K.bit_length() * (K.bit_length() - 1) // 2
        byts, ops = K * 8 + 2 * 5 * 4, 2 * K * steps
        t = measured(lambda: kernels.score_rows_trim_cuda(totals, 5), "score_rows_trim_kernel", sync)
        plain = p50_ms(lambda: kernels.topn_trim_plain(totals, 5), 15, sync)
        library = p50_ms(lambda: torch.topk(totals, 5), 15, sync)
        _times_line(f"K3 trim alone at K={K}", t, least_ms(byts, ops), plain,
                    f", torch.topk {library:.4f} ms")
        out[K] = (t, plain, library, byts, ops)
    return out


def expected_counts(host):
    """{PQL: numpy answer} of the main path's 30 Counts."""
    return {pql_of(f, op, rows): int(oracle(host[f], op, rows)) for f, op, rows in
            main_path_queries()}


def _stream(ex, queries, want, threads, per_thread, seed):
    """``threads`` threads, each issuing ``per_thread`` Executor.execute_async
    Counts drawn from ``queries``, each waited on before the next: every
    future non-None and every answer equal to ``want``.  Returns (wall
    seconds, per-query latencies in ms)."""
    import threading

    lat, errors = [], []
    barrier = threading.Barrier(threads)

    def run(i):
        rng = np.random.default_rng(seed + i)
        try:
            barrier.wait(60)
            for q in rng.choice(queries, per_thread).tolist():
                t0 = time.perf_counter()
                fut = ex.execute_async("bench", q)
                if fut is None:
                    raise AssertionError(f"execute_async declined {q}")
                got = fut.result(120).results[0]
                lat.append((time.perf_counter() - t0) * 1e3)
                if got != want[q]:
                    raise AssertionError(f"{q} (execute_async): port {got} != numpy oracle {want[q]}")
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    workers = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(600)
    wall = time.perf_counter() - t0
    if errors or any(w.is_alive() for w in workers):
        raise AssertionError(f"the execute_async stream failed: {errors[:3]}")
    return wall, lat


# Every kernel wrapper's launch count by its name in the kernels line:
# (module of pilosa_tpu_torch.parallel, wrapper, counter).  Each wrapper adds
# one where it launches its kernel; every phase zeroes and reads its
# launches through this one table.
KERNEL_COUNTERS = {
    "count_tree_dense": ("kernels", "count_tree_dense", "launches"),
    "count_tree_blocks": ("sparse", "count_tree_blocks_cuda", "launches"),
    "count_tree_pool": ("kernels", "count_tree_pool", "launches"),
    "score_rows": ("kernels", "score_rows_cuda", "launches"),
    "topn_trim": ("kernels", "score_rows_cuda", "trims"),
    "score_rows_pool": ("kernels", "score_rows_pool_cuda", "launches"),
    "and_popcount_rows": ("kernels", "and_popcount_rows_cuda", "launches"),
    "count_batch_tree": ("kernels", "count_batch_tree_cuda", "launches"),
    "count_batch_tree_pool": ("kernels", "count_batch_tree_pool_cuda", "launches"),
    "sum_tree": ("bsi", "sum_tree_cuda", "launches"),
    "sum_tree_pool": ("bsi", "sum_tree_pool_cuda", "launches"),
    "minmax_tree": ("bsi", "minmax_tree_cuda", "launches"),
    "minmax_tree_pool": ("bsi", "minmax_tree_pool_cuda", "launches"),
    "groupn_tree": ("groupby", "groupn_tree_cuda", "launches"),
    "groupn_tree_pool": ("groupby", "groupn_tree_pool_cuda", "launches"),
    "fused_tree": ("kernels", "fused_tree_cuda", "launches"),
    "fused_tree_pool": ("kernels", "fused_tree_pool_cuda", "launches"),
    "range_leaf": ("kernels", "range_leaf", "launches"),
    "rowb": ("kernels", "pool_leaf", "launches"),
    "topn_slab": ("kernels", "topn_slab_cuda", "launches"),
    "eval_tree": ("kernels", "eval_tree_cuda", "launches"),
    "score_rows_trim": ("kernels", "score_rows_trim_cuda", "launches"),
}
COUNT_KERNELS = ("count_tree_dense", "count_tree_blocks", "count_batch_tree")
BSI_KERNELS = ("range_leaf", "sum_tree", "minmax_tree") + COUNT_KERNELS
HTTP_KERNELS = BSI_KERNELS + ("score_rows", "groupn_tree", "fused_tree")
POOL_KERNELS = ("rowb", "count_tree_pool", "score_rows_pool", "sum_tree_pool",
                "minmax_tree_pool", "groupn_tree_pool", "count_batch_tree_pool",
                "fused_tree_pool")


def _counters(names):
    """(name, wrapper, counter) of ``names`` (None: every kernel), skipping
    a wrapper that a --root checkout does not have."""
    import importlib

    for name in KERNEL_COUNTERS if names is None else names:
        mod, fn, attr = KERNEL_COUNTERS[name]
        obj = getattr(importlib.import_module(f"pilosa_tpu_torch.parallel.{mod}"), fn, None)
        if obj is not None and hasattr(obj, attr):
            yield name, obj, attr


def zero_counts(names=None):
    for _, obj, attr in _counters(names):
        setattr(obj, attr, 0)


def read_counts(names=None):
    return {name: getattr(obj, attr) for name, obj, attr in _counters(names)}


def _launch_counts():
    return read_counts(COUNT_KERNELS)


def _zero_launches():
    zero_counts(COUNT_KERNELS)


def eight_counts(field):
    return "".join(pql_of(field, "and", (10 + 2 * k, 11 + 2 * k)) for k in range(8))


def run_serve_path(device, holder, engine, ex, host, seed, threads=64, per_thread=32):
    """Batched Count serving on the north-star index: a query of 8
    consecutive Counts on f and one on s, each one K5 launch and no K1 or
    K2 launch; ``threads`` x ``per_thread`` concurrent execute_async Counts
    (the 12 pairs and the Union/Difference/Xor trees of f and s) with the
    memo off, every answer against numpy, the K5 counter moved, a mean
    batch of at least 2 and no _QueryFuture fallback; the same stream again
    with the memo on, answered with no launch at all; then bench.py's
    config-2 index b10m.  Returns the phase's numbers, its K5 launches and
    the b10m K5 row."""
    import torch

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    want = expected_counts(host)
    log(f"serve: numpy oracle of {len(want)} Counts in {time.perf_counter() - t0:.3f} s")
    out = {}
    _zero_launches()
    for field in ("f", "s"):
        q = eight_counts(field)
        before = _launch_counts()
        got = ex.execute("bench", q).results
        exp = [want[pql_of(field, "and", (10 + 2 * k, 11 + 2 * k))] for k in range(8)]
        if got != exp:
            raise AssertionError(f"8 Counts on {field}: port {got} != numpy oracle {exp}")
        moved = {k: v - before[k] for k, v in _launch_counts().items()}
        if cuda and moved != {"count_tree_dense": 0, "count_tree_blocks": 0, "count_batch_tree": 1}:
            raise AssertionError(f"8 Counts on {field} launched {moved}, not one K5")
        log(f"serve: Executor.execute of 8 consecutive Count(Intersect) on {field} exact; "
            f"launches {moved}")

    queries = sorted(want)
    b = engine.batcher()
    b0, q0 = b.batches, b.batched_queries
    with memo_off(engine):
        wall, lat = _stream(ex, queries, want, threads, per_thread, seed)
    n = threads * per_thread
    batches, batched = b.batches - b0, b.batched_queries - q0
    launches = _launch_counts()
    mean = batched / max(1, batches)
    out["stream"] = {"queries": n, "threads": threads, "wall_s": wall, "qps": n / wall,
                     "p50_ms": statistics.median(lat), "p99_ms": float(np.percentile(lat, 99)),
                     "batches": batches, "batched_queries": batched, "mean_batch": mean,
                     "launches": launches, "fallbacks": ex.async_fallbacks}
    log(f"serve: {n} execute_async Counts from {threads} threads exact against numpy in "
        f"{wall:.3f} s: {n / wall:.1f} queries/s, p50 {statistics.median(lat):.4f} ms; "
        f"batches {batches}, batched_queries {batched}, mean batch {mean:.2f}; launches "
        f"{launches}; _QueryFuture fallbacks {ex.async_fallbacks}")
    if batched != n or mean < 2 or ex.async_fallbacks or (cuda and launches["count_batch_tree"] <= 0):
        raise AssertionError(f"serve stream: {out['stream']}")

    # The same stream with the memo on: one pass of each query fills it,
    # then every answer comes from it, with no launch.
    engine.result_memo.clear()
    for q in queries:
        if ex.execute_async("bench", q).result(300).results[0] != want[q]:
            raise AssertionError(f"{q}: the memo's warm pass disagrees with numpy")
    _zero_launches()
    b0 = b.batches
    wall_m, lat_m = _stream(ex, queries, want, threads, per_thread, seed)
    memo_launches = _launch_counts()
    out["memo_stream"] = {"wall_s": wall_m, "qps": n / wall_m, "p50_ms": statistics.median(lat_m),
                          "launches": memo_launches, "batches": b.batches - b0,
                          "memo_hits": engine.result_memo.hits}
    log(f"serve: the stream again from the result memo: {n / wall_m:.1f} queries/s, p50 "
        f"{statistics.median(lat_m):.4f} ms; launches {memo_launches}, batches {b.batches - b0}")
    if any(memo_launches.values()) or b.batches != b0 or ex.async_fallbacks:
        raise AssertionError(f"memo stream: {out['memo_stream']}")
    with memo_off(engine):
        out["serial_count_p50_ms"] = {f: count_p50_ms(ex, f) for f in ("f", "s")}
        out["eight_counts_p50_ms"] = eight_count_p50_ms(ex)
    log(f"serve: serial Count(Intersect) p50 {json.dumps(out['serial_count_p50_ms'])} ms against "
        f"the stream's {statistics.median(lat):.4f} ms; the 8-Count query p50 "
        f"{out['eight_counts_p50_ms']:.4f} ms")
    out["b10m"], b10m_row = run_b10m(device, holder, engine, seed)
    return out, launches["count_batch_tree"], b10m_row


def eight_count_p50_ms(ex, reps=24):
    """p50 of Executor.execute of the 8-Count query on f (host clock around
    a synchronous answer)."""
    q = eight_counts("f")
    ex.execute("bench", q)
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ex.execute("bench", q)
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


N_SHARDS_10M = 10  # bench.py:67
F10_ROWS = range(100, 228)  # bench.py:69: 32 disjoint 4-row trees
C2_B = 32  # bench.py:523: queries per batched dispatch


def run_b10m(device, holder, engine, seed):
    """bench.py's config 2 (bench.py:457-468, 509-532): index b10m of 10
    shards and 128 dense random rows of f (its BSI field v10 waits for the
    BSI slice); the 32 trees Xor(Difference(Union(a, b), c), d) over
    disjoint rows against numpy, then setops_tree_10M_cols_p50 (device time
    of one 32-query count_many over 32) and setops_tree_single_dispatch_p50
    (device time of one such Count alone), and K5's row at K = 32."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.core.view import VIEW_STANDARD
    from pilosa_tpu_torch.parallel import kernels
    from pilosa_tpu_torch.parallel.engine import _Lowering

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rng = np.random.default_rng(seed + 10)
    t0 = time.perf_counter()
    words = {r: rng.integers(0, 1 << 64, (N_SHARDS_10M, W64), dtype=np.uint64) for r in F10_ROWS}
    view = holder.create_index("b10m").create_field("f").view_if_not_exists(VIEW_STANDARD)
    for sh in range(N_SHARDS_10M):
        frag = view.fragment_if_not_exists(sh)
        for r in F10_ROWS:
            frag.load_row_words(r, words[r][sh])
        frag.cache.invalidate()
    shards = list(range(N_SHARDS_10M))
    trees = []
    for k in range(len(F10_ROWS) // 4):
        a = 100 + 4 * k
        trees.append(f"Xor(Difference(Union(Row(f={a}), Row(f={a + 1})), Row(f={a + 2})), "
                     f"Row(f={a + 3}))")
    want = [int(popcounts(((words[a] | words[a + 1]) & ~words[a + 2]) ^ words[a + 3]).sum())
            for a in range(100, 228, 4)]
    calls = [pql.parse(t).calls[0] for t in trees]
    engine.field_stack("b10m", "f", "standard")
    sync()
    log(f"serve: b10m ({N_SHARDS_10M} shards, 128 rows of f) made and uploaded in "
        f"{time.perf_counter() - t0:.3f} s")
    got = engine.count_many("b10m", calls, [shards] * C2_B)
    if got != want:
        raise AssertionError(f"b10m count_many: port {got} != numpy oracle {want}")
    with memo_off(engine):
        singles = [engine.count("b10m", c, shards) for c in calls]
    if singles != want:
        raise AssertionError(f"b10m single Counts: port {singles} != numpy oracle {want}")
    log("serve: b10m's 32 four-row trees exact against numpy, batched and one by one")
    out = {}
    if not cuda:
        return out, None
    it = iter(range(10 ** 9))

    def batch():
        i = next(it)
        return engine.count_many_async("b10m", [calls[(i + j) % C2_B] for j in range(C2_B)],
                                       [shards] * C2_B)

    def single():
        return engine.count_async("b10m", calls[next(it) % C2_B], shards)

    with memo_off(engine):
        for _ in range(3):
            batch()
            single()
        sync()
        dev_batch = device_ms(batch, "count_batch_tree_kernel")
        dev_single = device_ms(single, "count_tree_dense_kernel")
        ms_batch = p50_ms(batch, 15, sync)
        ms_single = p50_ms(single, 15, sync)
    out["setops_tree_10M_cols_p50"] = dev_batch / C2_B
    out["setops_tree_single_dispatch_p50"] = dev_single
    out["batch_ms_per_query"] = ms_batch / C2_B
    out["single_ms"] = ms_single
    log(f"serve: setops_tree_10M_cols_p50 {dev_batch / C2_B:.6f} ms per query (K5, "
        f"{dev_batch:.4f} ms per 32-query launch, torch.profiler); "
        f"setops_tree_single_dispatch_p50 {dev_single:.6f} ms (K1); CUDA events around "
        f"the engine call: {ms_batch / C2_B:.4f} ms per batched query, {ms_single:.4f} ms single")

    # K5's row at K = 32 on b10m.
    lw = _Lowering(engine, engine.canonical_shards("b10m"))
    progs = [engine._lower("b10m", c, lw) for c in calls]
    masks = np.ones((1, N_SHARDS_10M), dtype=bool)
    ids = [0] * C2_B
    k5 = kernels.count_batch_tree(progs, lw.mats, masks, ids, device)
    if k5.tolist() != want:
        raise AssertionError(f"K5 on b10m: {k5.tolist()} != {want}")

    def call():
        return kernels.count_batch_tree(progs, lw.mats, masks, ids, device)

    t = measured(call, "count_batch_tree_kernel", sync)
    plain = p50_ms(lambda: kernels.count_batch_tree_plain(progs, lw.mats, masks, ids, device), 5,
                   sync, batch=1)
    byts, ops = batch_bound(progs, lw.mats, masks, ids, N_SHARDS_10M)
    bound = least_ms(byts, ops)
    _times_line(f"K5 count_batch_tree at K={C2_B} on b10m", t, bound, plain)
    return out, {"times": t, "plain_ms": plain, "bytes": byts, "ops": ops, "bound_ms": bound,
                 "distinct_leaves": 128}


def k5_entry(rows_f, row_b10m, launches, err):
    """K5's {"kernels": [...]} entry: the main columns at K = 64 on f, the
    other shapes under "at"."""
    main = rows_f[64]
    e = _entry("count_batch_tree", "pilosa_tpu_torch/csrc/count_batch_tree.cu",
               "pilosa_tpu/parallel/kernels.py:255", launches, err["count_batch_tree"],
               main["times"], main["plain_ms"], main["bytes"], main["ops"], None)
    e["shape"] = "K=64 distinct two-row trees on f, 960 shards"
    e["k1_launches_device_ms"] = main["k1_launches_device_ms"]
    e["at"] = {f"K={k} on f": {**r["times"], "bound_ms": r["bound_ms"], "plain_ms": r["plain_ms"],
                               "distinct_leaves": r["distinct_leaves"],
                               "k1_launches_device_ms": r["k1_launches_device_ms"]}
               for k, r in rows_f.items()}
    if row_b10m is not None:
        e["at"]["K=32 on b10m"] = {**row_b10m["times"], "bound_ms": row_b10m["bound_ms"],
                                   "plain_ms": row_b10m["plain_ms"]}
    return e


# -- the bsi phase: BSI Sum/Min/Max, Range conditions, time-quantum Range ----

BSI_DEPTH = 8  # field v: min 0, max 255 (bench.py:71,410-412)
T_ROWS = (7, 8)  # field t's rows (bench.py:413,442-447)
T_VIEWS = ("standard", "standard_2018", "standard_201801", "standard_201802",
           "standard_201803")
T_SPAN = ("2018-01-01T00:00", "2018-04-01T00:00")  # three month views (bench.py:535-543)


def build_bsi_fields(holder, n_shards, seed):
    """bench.py's BSI field v (planes 0..7 random, the not-null plane all
    ones) and time field t (rows 7 and 8, the same words in the standard,
    year and three month views) on index "bench".  Returns ({plane:
    uint64[S, W64]}, {row: uint64[S, W64]}): the arrays the fragments
    hold."""
    from pilosa_tpu_torch.core.field import FieldOptions

    rng = np.random.default_rng(seed + 11)
    idx = holder.index("bench")
    v = idx.create_field("v", FieldOptions(type="int", min=0, max=(1 << BSI_DEPTH) - 1))
    t = idx.create_field("t", FieldOptions(type="time", time_quantum="YMD"))
    planes = {i: rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64)
              for i in range(BSI_DEPTH)}
    planes[BSI_DEPTH] = np.full((n_shards, W64), (1 << 64) - 1, dtype=np.uint64)
    trows = {r: rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64) for r in T_ROWS}
    for sh in range(n_shards):
        frag = v.view_if_not_exists("bsig_v").fragment_if_not_exists(sh)
        for i, words in planes.items():
            frag.load_row_words(i, words[sh])
        frag.cache.invalidate()
        for view in T_VIEWS:
            frag = t.view_if_not_exists(view).fragment_if_not_exists(sh)
            for r in T_ROWS:
                frag.load_row_words(r, trows[r][sh])
            frag.cache.invalidate()
    return planes, trows


def _bits(words):
    """uint64[S, W64] -> uint8[S, 2^20] of 0/1, bit p of a shard at column p."""
    return np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")


def value_hists(planes, filters, chunk=16):
    """Per filter (None: every column), the per-shard histogram int64[S,
    256] of the values of the not-null columns that pass it, each column's
    value assembled from its unpacked plane bits (BSI_DEPTH planes): the
    numpy oracle of the bsi phase, its chunks of shards on 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    S = planes[0].shape[0]
    out = [np.zeros((S, 1 << BSI_DEPTH), np.int64) for _ in filters]

    def one(a):
        b = min(S, a + chunk)
        vals = np.zeros((b - a, 1 << 20), np.uint8)
        for i in range(BSI_DEPTH):
            vals |= _bits(planes[i][a:b]) << i
        code = vals.astype(np.int32) | (np.arange(b - a, dtype=np.int32)[:, None] << 9)
        keep = _bits(planes[BSI_DEPTH][a:b])
        for h, flt in zip(out, filters):
            sel = keep if flt is None else keep & _bits(flt[a:b])
            n = np.bincount((code | (sel.astype(np.int32) << 8)).ravel(),
                            minlength=(b - a) << 9)
            h[a:b] = n.reshape(b - a, 2, 1 << BSI_DEPTH)[:, 1]

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(0, S, chunk)))
    return out


def hist_sum(h, shards, where=None):
    """(total, count) of Sum over the shards' histograms, the values
    limited to ``where`` (bool[2^depth]) when given."""
    h = h[shards] if where is None else h[shards] * where
    return int((h * np.arange(h.shape[1])).sum()), int(h.sum())


def hist_minmax(h, shards, is_min, where=None):
    """(value, count) as the reference's ValCount reduce gives them: each
    shard's extreme and its count there, the shards in canonical order,
    the first shard's count standing on a tie; (0, 0) when empty."""
    best, n = 0, 0
    for sh in shards:
        row = h[sh] if where is None else h[sh] * where
        nz = np.flatnonzero(row)
        if not nz.size:
            continue
        v = int(nz[0] if is_min else nz[-1])
        if n == 0 or (v < best if is_min else v > best):
            best, n = v, int(row[v])
    return best, n


def bsi_range_queries(n_shards):
    """(Count query, value condition bool[256] or "zero"/"nn", shards)."""
    vals = np.arange(1 << BSI_DEPTH)
    every = list(range(n_shards))
    subset = list(range(0, n_shards, 3))
    cases = [
        ("v > 100", vals > 100), ("v >= 100", vals >= 100), ("v < 37", vals < 37),
        ("v <= 37", vals <= 37), ("v == 7", vals == 7), ("v != 7", vals != 7),
        ("v >< [10, 200]", (vals >= 10) & (vals <= 200)), ("v >< [0, 1]", vals <= 1),
        # PQL reads a < v < b as BETWEEN [a + 1, b] (pql/parser.py).
        ("10 < v < 200", (vals > 10) & (vals <= 200)),
        ("v != null", vals >= 0), ("v > 300", vals < 0), ("v < 0", vals < 0),
        ("v >= 0", vals >= 0), ("v <= 255", vals >= 0), ("v > -5", vals >= 0),
        ("v >< [-10, 300]", vals >= 0), ("v == 300", vals < 0), ("v != 300", vals >= 0),
    ]
    return [(f"Count(Range({c}))", w, sh) for c, w in cases for sh in (every, subset)]


def _bsi_counters():
    """_launch_counts, and the range leaf's, K6's and K7's."""
    return read_counts(BSI_KERNELS)


def _zero_bsi_counters():
    zero_counts(BSI_KERNELS)


def _vc(res):
    return (res.val, res.count)


def time_k5_ranges(engine, lw, canonical, eight, gt, device, err):
    """K5 over 8 and 16 range conditions on v in one launch (the 8
    Range(v > x) of the bsi phase, whose numpy answers are ``gt``, then 16
    of every kind), each held against its plain version, then timed
    (``measured``) beside its bound (``batch_bound``), the plain p50 and
    the same trees as K1 launches (held against K5's answers).  Returns
    {"k5_ranges": ..., "k5_ranges_16": ...}."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel import kernels

    sync = torch.cuda.synchronize
    S = len(canonical)
    k5_masks = np.ones((1, S), dtype=bool)
    out = {}
    kinds = ("<", "<=", "==", "!=", ">=", ">", "><")
    sixteen = eight + [engine._lower("bench", pql.parse(
        f"Range(v {kinds[k % 7]} {x})" if kinds[k % 7] != "><" else
        f"Range(v >< [{x}, {x + 90}])").calls[0], lw) for k, x in enumerate(
            np.linspace(20, 230, 8).astype(int).tolist())]
    for name, progs in (("k5_ranges", eight), ("k5_ranges_16", sixteen)):
        K = len(progs)

        def k5_call(progs=progs, K=K):
            return kernels.count_batch_tree(progs, lw.mats, k5_masks, [0] * K, device)

        got = k5_call()
        err["count_batch_tree"] = max(err["count_batch_tree"], _exact(
            "K5", got, kernels.count_batch_tree_plain(progs, lw.mats, k5_masks, [0] * K,
                                                      device), f"{K} conditions on v"))
        for _ in range(3):
            k5_call()
        sync()
        t = measured(k5_call, "count_batch_tree_kernel", sync)
        byts, ops = batch_bound(progs, lw.mats, k5_masks, [0] * K, S)
        bound = least_ms(byts, ops)
        plain = p50_ms(lambda progs=progs, K=K: kernels.count_batch_tree_plain(
            progs, lw.mats, k5_masks, [0] * K, device), 3, sync, batch=1)
        k1_ms = k1_launches_ms(engine, progs, lw.mats, canonical,
                               gt if K == 8 else got.tolist())
        _times_line(f"K5 count_batch_tree, {K} range conditions on v (S={S})", t, bound,
                    plain, f"; the same {K} trees as {K} K1 launches: {k1_ms:.4f} ms of "
                    f"device time (torch.profiler); {bound / t['device_ms'] * 100:.1f}% of "
                    "the bound")
        out[name] = {**t, "bound_ms": bound, "bytes": byts, "ops": ops, "plain_ms": plain,
                     "k1_launches_device_ms": k1_ms}
    return out


def run_bsi_path(device, holder, engine, ex, host, seed, err):
    """The bsi phase on the north-star index, after serve and before the
    writes of phase 5: bench.py's fields v and t, then through
    Executor.execute, each against a numpy oracle over the host words:
    Sum/Min/Max of v unfiltered and filtered by Row(f=10) and by Range(v >
    100); Count(Range(v <op> N)) for every op, BETWEEN, != null and the
    out-of-range cases, on all shards and on every third;
    Count(Intersect(Row(f=10), Range(v > 100))); the time-quantum Counts
    of t=7 and t=8 over three month views; a query of consecutive Counts
    with Ranges among them (one K5 launch, none declined).  The
    launch counters, zeroed just before, must have moved for the range
    leaf, K6, K7 and K5, and the host lane must not have run.  Then K5
    with range leaves at the main path's shape against its plain version,
    and its time on 8 range Counts beside the same trees as K1 launches.  Then one
    Set(col, v=N) and an import_values of 2^20 values, each followed by
    Sum/Min/Max, with the stack synced in place, not rebuilt.  Returns
    the phase's numbers, its launches and its kernel entries."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel import bsi, kernels
    from pilosa_tpu_torch.parallel.engine import _Lowering

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n_shards = len(engine.canonical_shards("bench"))
    t_phase = t0 = time.perf_counter()
    planes, trows = build_bsi_fields(holder, n_shards, seed)
    for field, view in (("v", "bsig_v"),) + tuple(("t", v) for v in T_VIEWS[2:]):
        engine.field_stack("bench", field, view)
    sync()
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ora = [p.copy() for p in planes.values()]  # the fragments hold `planes` itself
    f10, f12 = host["f"][10], host["f"][12]
    h_all, h_f10, h_f12 = value_hists(ora, [None, f10, f12])
    oracle_s = time.perf_counter() - t0
    log(f"bsi: fields v ({BSI_DEPTH + 1} planes) and t ({len(T_ROWS)} rows x {len(T_VIEWS)} "
        f"views) made and their stacks built in {made_s:.3f} s; numpy oracle {oracle_s:.3f} s")
    every = list(range(n_shards))
    gt100 = np.arange(1 << BSI_DEPTH) > 100

    def agg_want(q):
        agg, _, rest = q.partition("(")
        h, where = h_all, None
        if rest.startswith("Row(f=10)"):
            h = h_f10
        elif rest.startswith("Range(v > 100)"):
            where = gt100
        if agg == "Sum":
            return hist_sum(h, every, where)
        return hist_minmax(h, every, agg == "Min", where)

    agg_qs = [f"{a}({flt}field=v)" for a in ("Sum", "Min", "Max")
              for flt in ("", "Row(f=10), ", "Range(v > 100), ")]
    range_qs = bsi_range_queries(n_shards)
    t_qs = [(f"Count(Range(t={r}, {T_SPAN[0]}, {T_SPAN[1]}))",
             int(popcounts(trows[r]).sum())) for r in T_ROWS]
    batch_q = ("Count(Range(v > 100)) Count(Intersect(Row(f=10), Row(f=11))) "
               "Count(Range(v < 37)) Count(Union(Row(f=12), Range(v == 7)))")
    eq7 = np.arange(1 << BSI_DEPTH) == 7
    batch_want = [hist_sum(h_all, every, gt100)[1],
                  int(popcounts(host["f"][10] & host["f"][11]).sum()),
                  hist_sum(h_all, every, np.arange(1 << BSI_DEPTH) < 37)[1],
                  int(popcounts(f12).sum()) + hist_sum(h_all, every, eq7)[1]
                  - hist_sum(h_f12, every, eq7)[1]]

    # The main path: every query once, the counters zeroed just before.
    fallbacks0, declines0 = ex.host_fallbacks, engine.batch_declines
    rebuilds0 = engine.stack_rebuilds
    with memo_off(engine):
        _zero_bsi_counters()
        for q in agg_qs:
            got, want = _vc(ex.execute("bench", q).results[0]), agg_want(q)
            if got != want:
                raise AssertionError(f"{q}: port {got} != numpy oracle {want}")
        for q, where, shards in range_qs:
            got = ex.execute("bench", q, shards=shards).results[0]
            want = hist_sum(h_all, shards, where)[1]
            if got != want:
                raise AssertionError(f"{q} over {len(shards)} shards: port {got} != numpy {want}")
        q = "Count(Intersect(Row(f=10), Range(v > 100)))"
        got, want = ex.execute("bench", q).results[0], hist_sum(h_f10, every, gt100)[1]
        if got != want:
            raise AssertionError(f"{q}: port {got} != numpy oracle {want}")
        for q, want in t_qs:
            got = ex.execute("bench", q).results[0]
            if got != want:
                raise AssertionError(f"{q}: port {got} != numpy oracle {want}")
        k5_before = read_counts(COUNT_KERNELS)
        got = ex.execute("bench", batch_q).results
        if got != batch_want:
            raise AssertionError(f"{batch_q}: port {got} != numpy oracle {batch_want}")
        launches = _bsi_counters()
    batch_launches = {k: launches[k] - k5_before[k] for k in COUNT_KERNELS}
    declines = engine.batch_declines - declines0
    fallbacks = ex.host_fallbacks - fallbacks0
    log(f"bsi: {len(agg_qs)} Sum/Min/Max, {len(range_qs) + 1} range Counts, {len(t_qs)} "
        f"time-range Counts and a 4-Count query exact against numpy; launches {launches}, "
        f"the 4-Count query's {batch_launches}, K5 declines {declines}, host-lane fallbacks "
        f"{fallbacks}")
    if fallbacks or declines or engine.stack_rebuilds != rebuilds0:
        raise AssertionError(f"bsi: host-lane fallbacks {fallbacks} (want 0), K5 declines "
                             f"{declines} (want 0), rebuilds {engine.stack_rebuilds - rebuilds0}")
    if cuda and batch_launches != {"count_tree_dense": 0, "count_tree_blocks": 0,
                                   "count_batch_tree": 1}:
        raise AssertionError(f"bsi: the 4-Count query with 3 range trees launched "
                             f"{batch_launches}, not one K5")
    if cuda and min(launches[k] for k in ("range_leaf", "sum_tree", "minmax_tree",
                                          "count_tree_dense", "count_batch_tree")) <= 0:
        raise AssertionError(f"a kernel of the bsi path never launched: {launches}")

    # Each kernel at the main path's shape, held against its plain version.
    canonical = engine.canonical_shards("bench")
    S = len(canonical)
    lw = _Lowering(engine, canonical)
    rprog = engine._lower("bench", pql.parse("Range(v > 100)").calls[0], lw)
    tprog = engine._lower("bench", pql.parse(t_qs[0][0]).calls[0].children[0], lw)
    vst = engine.field_stack("bench", "v", "bsig_v", canonical)
    vplanes = engine._plane_spec(vst, BSI_DEPTH)
    mask = engine._mask_words(canonical, canonical)
    calls = {
        "range_leaf": (lambda: kernels.count_tree(rprog, lw.mats, mask),
                       lambda: kernels.count_tree_plain(rprog, lw.mats, mask)),
        "time_range": (lambda: kernels.count_tree(tprog, lw.mats, mask),
                       lambda: kernels.count_tree_plain(tprog, lw.mats, mask)),
        "sum_tree": (lambda: bsi.sum_tree(None, [], mask, vst.matrix, vplanes),
                     lambda: bsi.sum_tree_plain(None, [], mask, vst.matrix, vplanes)),
        "minmax_tree": (lambda: torch.stack(bsi.minmax_tree(None, [], mask, vst.matrix,
                                                            vplanes, True)),
                        lambda: torch.stack(bsi.minmax_tree_plain(None, [], mask, vst.matrix,
                                                                  vplanes, True))),
    }
    for name, (fn, plain) in calls.items():
        got, want = fn(), plain()
        sync()
        key = "range_leaf" if name == "time_range" else name
        err[key] = max(err.get(key, 0), _exact(name, got.reshape(-1), want.reshape(-1),
                                               "at the main path's shape"))
    # K5 with range leaves at the main path's shape: 8 Count(Range(v >
    # x_k)), a BETWEEN and Intersect(Row(f=10), Range(v > 100)) in one
    # batch, held against its plain version; then the 8 ranges alone
    # timed against the same 8 trees as K1 launches (what the engine ran
    # before K5 took range leaves) and against K5's bound.
    thresholds = [int(x) for x in np.linspace(16, 240, 8)]
    k5_qs = [f"Range(v > {x})" for x in thresholds] + [
        "Range(v >< [10, 200])", "Intersect(Row(f=10), Range(v > 100))"]
    k5_progs = [engine._lower("bench", pql.parse(q).calls[0], lw) for q in k5_qs]
    k5_masks = np.ones((1, S), dtype=bool)
    got = kernels.count_batch_tree(k5_progs, lw.mats, k5_masks, [0] * len(k5_progs), device)
    want = kernels.count_batch_tree_plain(k5_progs, lw.mats, k5_masks, [0] * len(k5_progs),
                                          device)
    sync()
    err["count_batch_tree"] = max(err.get("count_batch_tree", 0), _exact(
        "K5", got, want, "with range leaves on v at the main path's shape"))
    gt = [int(hist_sum(h_all, every, np.arange(1 << BSI_DEPTH) > x)[1]) for x in thresholds]
    if got.tolist()[:8] != gt:
        raise AssertionError(f"K5 range Counts {got.tolist()[:8]} != numpy {gt}")
    out = {"made_s": made_s, "oracle_s": oracle_s, "launches": launches,
           "k5_declines": declines, "host_fallbacks": fallbacks,
           "batch_query_launches": batch_launches}
    entries = []
    if cuda:
        rows_bytes = lambda n: n * S * 32768 * 4  # noqa: E731
        kernel_of = {"range_leaf": "count_tree_dense_kernel", "time_range": "count_tree_dense_kernel",
                     "sum_tree": "sum_tree_kernel", "minmax_tree": "minmax_tree_kernel"}
        times = {}
        for name, (fn, plain) in calls.items():
            for _ in range(3):
                fn()
            sync()
            times[name] = measured(fn, kernel_of[name], sync)
            times[name]["plain_ms"] = p50_ms(plain, 3, sync, batch=1)
        # Least time: each plane (or leaf row) of the requested shards read
        # once; per word position (a word of one row), the integer
        # operations and popcounts: the range walk one three-input logic
        # operation a plane word, then an add and a popcount; the time
        # range two ORs, an add and a popcount; Sum an AND, an add and a
        # popcount a plane word; Min/Max six operations a plane word.
        spec = {"range_leaf": (BSI_DEPTH + 1, BSI_DEPTH + 2, 1), "time_range": (3, 3, 1),
                "sum_tree": (BSI_DEPTH + 1, 2 * (BSI_DEPTH + 1), BSI_DEPTH + 1),
                "minmax_tree": (BSI_DEPTH + 1, 6 * (BSI_DEPTH + 1), 1)}
        for name, t in times.items():
            n_rows, n_int, n_popc = spec[name]
            pos = rows_bytes(1) // 4
            byts, n_ops = rows_bytes(n_rows) + S * 4 + 8, (pos * n_int, pos * n_popc)
            bound = least_ms(byts, n_ops)
            _times_line(f"bsi {name}", t, bound, t["plain_ms"])
            out[f"{name}_device_ms"], out[f"{name}_bound_ms"] = t["device_ms"], bound
        out.update(time_k5_ranges(engine, lw, canonical, k5_progs[:8], gt, device, err))
        for name, src, rep in (
                ("range_leaf", "pilosa_tpu_torch/csrc/tree_eval.cuh",
                 "pilosa_tpu/parallel/kernels.py:108"),
                ("sum_tree", "pilosa_tpu_torch/csrc/sum_tree.cu",
                 "pilosa_tpu/parallel/kernels.py:474"),
                ("minmax_tree", "pilosa_tpu_torch/csrc/minmax_tree.cu",
                 "pilosa_tpu/parallel/kernels.py:511")):
            t = times[name]
            n_rows, n_int, n_popc = spec[name]
            pos = rows_bytes(1) // 4
            entries.append(_entry(name, src, rep, launches[name], err[name], t, t["plain_ms"],
                                  rows_bytes(n_rows) + S * 4 + 8, (pos * n_int, pos * n_popc),
                                  None))
        # bench.py's metrics: the engine call (CUDA events around 10 calls,
        # per call) and Executor.execute (host clock around a synchronous
        # answer), memo off; the time-range Count alternates t=7 and t=8.
        it = iter(range(10 ** 9))
        tcalls = [pql.parse(q).calls[0].children[0] for q, _ in t_qs]
        with memo_off(engine):
            out["sum_bsi_1B_cols_p50"] = p50_ms(
                lambda: engine.sum_async("bench", "v", None, canonical)[0], 12, sync)
            for agg, is_min in (("min", True), ("max", False)):
                out[f"{agg}_bsi_1B_cols_p50"] = p50_ms(
                    lambda: engine.min_max_async("bench", "v", None, canonical, is_min)[0][0],
                    12, sync)
            out["timerange_1B_cols_p50"] = p50_ms(
                lambda: engine.count_async("bench", tcalls[next(it) % 2], canonical), 24, sync)
            for agg in ("Sum", "Min", "Max"):
                lat = []
                for _ in range(24):
                    t0 = time.perf_counter()
                    ex.execute("bench", f"{agg}(field=v)")
                    lat.append((time.perf_counter() - t0) * 1e3)
                out[f"{agg.lower()}_bsi_1B_cols_e2e_p50"] = statistics.median(lat)
        log("bsi: " + ", ".join(f"{k} {out[k]:.4f} ms" for k in (
            "sum_bsi_1B_cols_p50", "min_bsi_1B_cols_p50", "max_bsi_1B_cols_p50",
            "sum_bsi_1B_cols_e2e_p50", "min_bsi_1B_cols_e2e_p50", "max_bsi_1B_cols_e2e_p50",
            "timerange_1B_cols_p50")) + f"; {card_line()}")

    # Writes: one Set(col, v=N), then an import_values of 2^20 values, each
    # followed by Sum/Min/Max against the oracle, the stack synced in place.
    rng = np.random.default_rng(seed + 12)
    updates0, rebuilds0 = engine.stack_updates, engine.stack_rebuilds

    def old_values(cols):
        sh, pos = cols >> 20, cols & ((1 << 20) - 1)
        w, b = pos >> 6, (pos & 63).astype(np.uint64)
        return sum(((ora[i][sh, w] >> b) & np.uint64(1)).astype(np.int64) << i
                   for i in range(BSI_DEPTH))

    def apply(cols, vals):
        """The writes of (cols, vals) on the oracle: the histograms, then
        the copied planes."""
        sh, old = cols >> 20, old_values(cols)
        for h, flt in ((h_all, None), (h_f10, f10), (h_f12, f12)):
            keep = np.ones(cols.size, bool) if flt is None else (
                (flt[sh, (cols & 0xFFFFF) >> 6] >> (cols & 63).astype(np.uint64)) & np.uint64(1)
            ).astype(bool)
            np.add.at(h, (sh[keep], old[keep]), -1)
            np.add.at(h, (sh[keep], vals[keep]), 1)
        pos = cols & 0xFFFFF
        for i in range(BSI_DEPTH):
            bit = np.uint64(1) << (pos & 63).astype(np.uint64)
            on = ((vals >> i) & 1).astype(bool)
            ora[i][sh[on], pos[on] >> 6] |= bit[on]
            ora[i][sh[~on], pos[~on] >> 6] &= ~bit[~on]

    def check_aggs(what):
        with memo_off(engine):
            for q in agg_qs[::3] + agg_qs[1::3]:
                got, want = _vc(ex.execute("bench", q).results[0]), agg_want(q)
                if got != want:
                    raise AssertionError(f"{what}, {q}: port {got} != numpy oracle {want}")

    col = np.asarray([int(rng.integers(0, n_shards << 20))])
    val = np.asarray([int(rng.integers(0, 1 << BSI_DEPTH))])
    t0 = time.perf_counter()
    ex.execute("bench", f"Set({int(col[0])}, v={int(val[0])})")
    apply(col, val)
    check_aggs(f"after Set({int(col[0])}, v={int(val[0])})")
    set_ms = (time.perf_counter() - t0) * 1e3
    cols = np.unique(rng.integers(0, n_shards << 20, (1 << 20) + (1 << 16)))
    cols = rng.permutation(cols)[: 1 << 20]
    vals = rng.integers(0, 1 << BSI_DEPTH, cols.size)
    t0 = time.perf_counter()
    holder.index("bench").field("v").import_values(cols, vals)
    import_s = time.perf_counter() - t0
    apply(cols, vals)
    t0 = time.perf_counter()
    engine.field_stack("bench", "v", "bsig_v")
    sync()
    sync_s = time.perf_counter() - t0
    check_aggs(f"after import_values of {cols.size} values")
    updates = engine.stack_updates - updates0
    if engine.stack_rebuilds != rebuilds0 or updates < 2:
        raise AssertionError(f"bsi writes: {engine.stack_rebuilds - rebuilds0} rebuilds "
                             f"(want 0), {updates} in-place syncs (want 2)")
    log(f"bsi: Set then Sum/Min/Max {set_ms:.3f} ms; import_values of {cols.size} values "
        f"{import_s:.3f} s, its in-place sync {sync_s:.3f} s; Sum/Min/Max exact after each; "
        f"stack_updates +{updates}, stack_rebuilds +0")
    out.update({"set_then_aggs_ms": set_ms, "import_values_s": import_s,
                "import_sync_s": sync_s, "stack_updates": updates,
                "wall_s": time.perf_counter() - t_phase})
    return out, entries


# -- the groupby phase: GroupBy and Rows (config 5) ----------------------------

G_ROWS = {"ga": 4, "gb": 2, "gc": 2}  # bench.py:75-77 GROUPS_A, _B, _C
Q8 = "GroupBy(Rows(field=ga), Rows(field=gb))"
Q3 = "GroupBy(Rows(field=ga), Rows(field=gb), Rows(field=gc))"
# A GroupBy whose shape takes K8's walk: ga x gb x top, 4 x 2 x 16 = 128
# combinations (top first in level order, 6 rows staged a pass).
QW = "GroupBy(Rows(field=ga), Rows(field=gb), Rows(field=top))"
GROUP_ROWS = {**G_ROWS, "top": len(TOP_ROWS)}


def build_group_fields(holder, n_shards, seed):
    """bench.py's config-5 fields ga, gb and gc on index "bench" (rows
    rand & rand, bench.py:448-456).  Returns {field: {row: uint64[S,
    W64]}}, the arrays the fragments hold."""
    rng = np.random.default_rng(seed + 14)
    idx = holder.index("bench")
    host = {}
    for name, n in G_ROWS.items():
        host[name] = {r: rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64)
                      & rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64)
                      for r in range(n)}
        view = idx.create_field(name).view_if_not_exists("standard")
        for sh in range(n_shards):
            frag = view.fragment_if_not_exists(sh)
            for r, words in host[name].items():
                frag.load_row_words(r, words[sh])
            frag.cache.invalidate()
    return host


def v_greater(holder, n_shards, value):
    """uint64[S, W64]: the columns whose BSI value of v is above ``value``,
    from the planes the fragments hold now, by the textbook bit-sliced
    comparison (high plane first)."""
    out = np.empty((n_shards, W64), np.uint64)
    for sh in range(n_shards):
        frag = holder.fragment("bench", "v", "bsig_v", sh)
        planes = [frag.row_words(i).view(np.uint64) for i in range(BSI_DEPTH + 1)]
        eq, gt = planes[BSI_DEPTH].copy(), np.zeros(W64, np.uint64)
        for i in range(BSI_DEPTH - 1, -1, -1):
            if (value >> i) & 1:
                eq &= planes[i]
            else:
                gt |= eq & planes[i]
                eq &= ~planes[i]
        out[sh] = gt
    return out


class GroupOracle:
    """Per-shard combination counts of each (fields, filter) the queries
    name, from the host words; ``want`` assembles a GroupBy's result as
    the reference does (row-major, zero counts skipped, the progressive
    limit cut, then offset and limit)."""

    def __init__(self, host, filters, shapes):
        from concurrent.futures import ThreadPoolExecutor

        jobs = [(fields, fname, combo) for fields, fname in sorted(set(shapes), key=str)
                for combo in np.ndindex(*(GROUP_ROWS[f] for f in fields))]

        def one(job):
            fields, fname, combo = job
            w = host[fields[0]][combo[0]].copy()
            for f, r in zip(fields[1:], combo[1:]):
                w &= host[f][r]
            if filters[fname] is not None:
                w &= filters[fname]
            return job, popcounts(w)

        with ThreadPoolExecutor(8) as pool:
            self.per_shard = dict(pool.map(one, jobs))

    def want(self, fields, flt=None, shards=None, limit=None, offset=None, first=(0,)):
        out = []
        for combo in np.ndindex(*(GROUP_ROWS[f] for f in fields)):
            if combo[0] < first[0]:
                continue
            n = self.per_shard[(fields, flt, combo)]
            n = int(n.sum() if shards is None else n[shards].sum())
            if n > 0:
                out.append({"group": [{"field": f, "rowID": int(r)} for f, r in zip(fields, combo)],
                            "count": n})
            if limit is not None and len(out) >= limit:
                break
        if offset is not None and offset < len(out):
            out = out[offset:]
        return out if limit is None else out[:limit]


def k8_work(ks, filtered, n_shards):
    """(bytes, operations, bound ms) of one K8 launch over ``n_shards``
    requested shards, fields listing ``ks`` rows: each listed row (and
    the filter's row) read once, the mask, row list and counts; an AND, a
    popcount and an add per word and combination."""
    n_rows, C, words = sum(ks) + filtered, math.prod(ks), n_shards * 32768
    byts = n_rows * words * 4 + n_shards * 4 + 4 * n_rows + C * 8
    ops = (words * C * 2, words * C)
    return byts, ops, least_ms(byts, ops)


def group_queries(n_shards):
    """(query, shards or None, oracle arguments, fused) of the groupby
    phase: the fused lane's queries, then two on the host lane."""
    subset = list(range(0, n_shards, 3))
    f2, f3 = ("ga", "gb"), ("ga", "gb", "gc")
    return [
        (Q8, None, dict(fields=f2), True),
        (Q3, None, dict(fields=f3), True),
        (Q8[:-1] + ", filter=Row(f=10))", None, dict(fields=f2, flt="f10"), True),
        (Q3[:-1] + ", filter=Row(f=10))", None, dict(fields=f3, flt="f10"), True),
        (Q8[:-1] + ", filter=Range(v > 100))", None, dict(fields=f2, flt="v100"), True),
        (Q3[:-1] + ", filter=Range(v > 100))", None, dict(fields=f3, flt="v100"), True),
        (Q3[:-1] + ", limit=5)", None, dict(fields=f3, limit=5), True),
        (Q3[:-1] + ", limit=6, offset=2)", None, dict(fields=f3, limit=6, offset=2), True),
        (Q8, subset, dict(fields=f2, shards=subset), True),
        (Q3[:-1] + ", filter=Row(f=10))", subset, dict(fields=f3, flt="f10", shards=subset),
         True),
        (QW, None, dict(fields=("ga", "gb", "top")), True),
        ("GroupBy(Rows(field=ga, limit=2), Rows(field=gb))", None,
         dict(fields=f2, limit=4), False),
        ("GroupBy(Rows(field=ga, previous=1), Rows(field=gb), limit=5)", None,
         dict(fields=f2, limit=5, first=(1,)), False),
    ]


def run_groupby_path(device, holder, engine, ex, host, seed, err):
    """The groupby phase on the north-star index, after bsi and before the
    writes of phase 5: bench.py's fields ga, gb and gc (4, 2 and 2 rows
    of rand & rand over every shard), then through Executor.execute, each
    against a numpy oracle over the host words: the 8-way and 3-field
    GroupBy, with filter=Row(f=10), with filter=Range(v > 100) (a range
    leaf in K8), with limit/offset and on a shard subset, all on the fused
    lane (K8), whose launch counter must move with no host fallback, as
    must ga x gb x top (K8's walk); one with a child Rows(limit=) and one
    with previous= on the host lane; Rows(field=ga) with column=, limit=
    and previous=.  Then K8 at the 8-way, 3-field, filtered and 4 x 2 x
    16 shapes against its plain version and its bound, and
    bench.py's groupby_8way/3field_1B_cols_p50 and _e2e_p50.  Returns the
    phase's numbers and K8's kernel entry."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel import groupby
    from pilosa_tpu_torch.parallel.engine import _Lowering

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    canonical = engine.canonical_shards("bench")
    n_shards = len(canonical)
    t_phase = t0 = time.perf_counter()
    gh = build_group_fields(holder, n_shards, seed)
    for name in GROUP_ROWS:  # top's too: the new fields moved the shard epoch
        engine.field_stack("bench", name, "standard")
    sync()
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ora = GroupOracle({**gh, "top": host["top"]},
                      {None: None, "f10": host["f"][10], "v100": v_greater(holder, n_shards, 100)},
                      [(a["fields"], a.get("flt")) for _, _, a, _ in group_queries(n_shards)])
    oracle_s = time.perf_counter() - t0
    log(f"groupby: fields ga, gb, gc (8 rows, {8 * n_shards * W64 * 8 / 1e9:.3f} GB) made and "
        f"their stacks built in {made_s:.3f} s; numpy oracle {oracle_s:.3f} s")

    # The main path: every query once, the counters zeroed just before.
    fallbacks0, gfall0, rebuilds0 = ex.host_fallbacks, engine.group_host_fallbacks, \
        engine.stack_rebuilds
    with memo_off(engine):
        for fused in (True, False):
            zero_counts(("groupn_tree",))
            d0 = engine.group_dispatches
            n_q = 0
            for q, shards, args, lane in group_queries(n_shards):
                if lane != fused:
                    continue
                got = [g.to_dict() for g in ex.execute("bench", q, shards=shards).results[0]]
                want = ora.want(**args)
                if got != want or not got:
                    raise AssertionError(f"{q} over {len(shards or canonical)} shards: port "
                                         f"{got} != numpy oracle {want}")
                n_q += 1
            launches = groupby.groupn_tree_cuda.launches
            dispatches = engine.group_dispatches - d0
            if fused and (dispatches != n_q or (cuda and launches != n_q)):
                raise AssertionError(f"groupby: {n_q} fused queries made {dispatches} "
                                     f"dispatches and {launches} K8 launches")
            if not fused and (dispatches or launches):
                raise AssertionError(f"groupby: the host-lane queries made {dispatches} "
                                     f"dispatches and {launches} K8 launches")
            if fused:
                fused_launches = launches
    if (ex.host_fallbacks != fallbacks0 or engine.group_host_fallbacks != gfall0
            or engine.stack_rebuilds != rebuilds0):
        raise AssertionError(f"groupby: host-lane fallbacks {ex.host_fallbacks - fallbacks0}, "
                             f"group host fallbacks {engine.group_host_fallbacks - gfall0}, "
                             f"rebuilds {engine.stack_rebuilds - rebuilds0} (want 0 each)")
    col = int(np.random.default_rng(seed + 15).integers(0, n_shards << 20))
    has = [r for r in range(G_ROWS["ga"]) if _bit(gh["ga"][r], col)]
    for q, want in (("Rows(field=ga)", [0, 1, 2, 3]), ("Rows(field=ga, limit=2)", [0, 1]),
                    ("Rows(field=ga, previous=1)", [2, 3]), (f"Rows(field=ga, column={col})", has),
                    (f"Rows(field=ga, column={col}, limit=1)", has[:1]),
                    (f"Rows(field=ga, column={col}, previous=0)", [r for r in has if r > 0])):
        got = ex.execute("bench", q).results[0]
        if got != want:
            raise AssertionError(f"{q}: port {got} != numpy oracle {want}")
    n_fused = sum(1 for *_, lane in group_queries(n_shards) if lane)
    log(f"groupby: {len(group_queries(n_shards))} GroupBy queries ({n_fused} on the fused "
        f"lane, K8 launches {fused_launches}; 2 on the host lane) and 6 Rows queries exact "
        "against numpy; host-lane fallbacks 0, group host fallbacks 0")

    # K8 at the main path's shapes, held against its plain version: the
    # register form's three and the walk's one.
    stacks = {f: engine.field_stack("bench", f, "standard", canonical) for f in GROUP_ROWS}
    lists = {f: [stacks[f].row_index[r] for r in range(n)] for f, n in GROUP_ROWS.items()}
    mask = engine._mask_words(canonical, canonical)
    lw = _Lowering(engine, canonical)
    fprog = engine._lower("bench", pql.parse("Row(f=10)").calls[0], lw)
    shapes = {"8-way": (("ga", "gb"), None), "3-field": (("ga", "gb", "gc"), None),
              "8-way, filter=Row(f=10)": (("ga", "gb"), fprog),
              "walk, 4 x 2 x 16": (("ga", "gb", "top"), None)}
    calls = {}
    for name, (fields, prog) in shapes.items():
        fm, li = [stacks[f].matrix for f in fields], [lists[f] for f in fields]
        calls[name] = (lambda fm=fm, li=li, prog=prog: groupby.groupn_tree(prog, lw.mats, mask,
                                                                           fm, li),
                       lambda fm=fm, li=li, prog=prog: groupby.groupn_tree_plain(
                           prog, lw.mats, mask, fm, li))
        got, want = calls[name][0](), calls[name][1]()
        sync()
        err["groupn_tree"] = max(err.get("groupn_tree", 0), _exact(
            "K8", got, want, f"at the {name} shape"))
    out = {"made_s": made_s, "oracle_s": oracle_s, "k8_launches": fused_launches}
    entry = None
    if cuda:
        times = {}
        for name, (fn, plain) in calls.items():
            fields, prog = shapes[name]
            ks = [GROUP_ROWS[f] for f in fields]
            byts, ops, bound = k8_work(ks, prog is not None, n_shards)
            for _ in range(3):
                fn()
            sync()
            t = times[name] = measured(fn, "groupn_tree_kernel", sync, bound_ms=bound)
            t.update(plain_ms=p50_ms(plain, 3, sync, batch=1), bytes=byts, ops=ops,
                     bound_ms=bound, form=groupby.groupn_plan(ks)[0])
            _times_line(f"K8 groupn_tree {name} ({t['form']})", t, bound, t["plain_ms"],
                        f"; {bound / t['device_ms'] * 100:.1f}% of the bound")
            out[f"k8_{name}"] = {k: t[k] for k in ("ms", "device_ms", "host_us", "plain_ms",
                                                   "bound_ms", "form")}
        main = times["8-way"]
        entry = _entry("groupn_tree", "pilosa_tpu_torch/csrc/groupn_tree.cu",
                       "pilosa_tpu/parallel/kernels.py:707", fused_launches, err["groupn_tree"],
                       main, main["plain_ms"], main["bytes"], main["ops"], None)
        entry["shape"] = f"8-way: ga 4 x gb 2 rows, {n_shards} shards"
        entry["at"] = {k: out[f"k8_{k}"] for k in shapes if k != "8-way"}
        # bench.py's metrics: the engine call (CUDA events around 10 calls,
        # per call) and Executor.execute (host clock around a synchronous
        # answer), memo off.
        rows = {f: list(range(n)) for f, n in G_ROWS.items()}
        with memo_off(engine):
            for metric, fields, q in (("groupby_8way_1B_cols", ("ga", "gb"), Q8),
                                      ("groupby_3field_1B_cols", ("ga", "gb", "gc"), Q3)):
                out[f"{metric}_p50"] = p50_ms(lambda fields=fields: engine.group_counts_async(
                    "bench", list(fields), [rows[f] for f in fields], None, canonical), 12, sync)
                lat = []
                for _ in range(24):
                    t0 = time.perf_counter()
                    ex.execute("bench", q)
                    lat.append((time.perf_counter() - t0) * 1e3)
                out[f"{metric}_e2e_p50"] = statistics.median(lat)
        log("groupby: " + ", ".join(f"{k} {out[k]:.4f} ms" for k in (
            "groupby_8way_1B_cols_p50", "groupby_8way_1B_cols_e2e_p50",
            "groupby_3field_1B_cols_p50", "groupby_3field_1B_cols_e2e_p50")) + f"; {card_line()}")
    out["wall_s"] = time.perf_counter() - t_phase
    return out, entry


# -- the api phase: pilosa_tpu_torch.api.API on the north-star index ---------

FK_ROWS = 24  # field fk: keys "k00".."k23", drawn like f
# Index users: a quarter of one shard of column keys (the api phase's
# depth, cut from a full shard, 2^20, to keep the script's time).
USER_KEYS = 1 << 18
USER_BATCH = 1 << 16  # keys per import_bits request
SEGS = 8  # field seg: keyed rows "seg0".."seg7"
N_COL_ATTRS = 1000  # columns of users given attributes


def _words_of(cols):
    """uint64[W64] words of in-shard columns ``cols`` (int64, distinct)."""
    w = np.zeros(W64, dtype=np.uint64)
    np.bitwise_or.at(w, cols >> 6, np.uint64(1) << (cols & 63).astype(np.uint64))
    return w


def _api_p50s(api_q, ex_q, api, ex, index, reps=20):
    """p50 ms of API.query and of Executor.execute (the same query with
    ids) over ``reps`` warm runs each, host clock around a synchronous
    answer; the two alternate, so that both see the same host."""
    from pilosa_tpu_torch.api import QueryRequest

    calls = {"api_p50_ms": lambda: api.query(QueryRequest(index, api_q)),
             "executor_p50_ms": lambda: ex.execute(index, ex_q)}
    lat = {name: [] for name in calls}
    for fn in calls.values():
        fn()
    for _ in range(reps):
        for name, fn in calls.items():
            t0 = time.perf_counter()
            fn()
            lat[name].append((time.perf_counter() - t0) * 1e3)
    out = {name: statistics.median(v) for name, v in lat.items()}
    out["api_host_ms"] = out["api_p50_ms"] - out["executor_p50_ms"]
    return out


def build_keyed_field(api, holder, n_shards, seed):
    """Field fk (keys) on index bench: FK_ROWS dense random rows whose row
    keys "k00".. the API's translate store gives ids, filled as build_index
    fills f (load_row_words), not through import_bits.  Returns {key: id}
    and the host words {id: uint64[S, W64]}."""
    from pilosa_tpu_torch.core.view import VIEW_STANDARD

    rng = np.random.default_rng(seed + 9)
    keys = [f"k{r:02d}" for r in range(FK_ROWS)]
    api.create_field("bench", "fk", {"keys": True})
    ids = dict(zip(keys, api.translate_keys("bench", "fk", keys)))
    words = {i: rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64) for i in ids.values()}
    view = holder.index("bench").field("fk").view_if_not_exists(VIEW_STANDARD)
    for sh in range(n_shards):
        frag = view.fragment_if_not_exists(sh)
        for i, w in words.items():
            frag.load_row_words(i, w[sh])
        frag.cache.invalidate()
    return ids, words


def import_users(api, n_keys, seed):
    """Index users (keys) and field seg (keys): every column key one seg
    row, one in four a second, through API.import_bits in batches of
    USER_BATCH row keys x column keys.  Returns the keys, the (column
    index, seg) pairs imported and the seconds (translation included)."""
    from pilosa_tpu_torch.api import ImportRequest

    rng = np.random.default_rng(seed + 11)
    users = [f"u{i:07d}" for i in range(n_keys)]
    segs = [f"seg{k}" for k in range(SEGS)]
    api.create_index("users", keys=True)
    api.create_field("users", "seg", {"keys": True})
    first = rng.integers(0, SEGS, n_keys)
    extra = np.flatnonzero(rng.random(n_keys) < 0.25)
    second = (first[extra] + rng.integers(1, SEGS, extra.size)) % SEGS
    cols = np.concatenate([np.arange(n_keys), extra])
    rows = np.concatenate([first, second])
    t0 = time.perf_counter()
    for b in range(0, cols.size, USER_BATCH):
        c, r = cols[b: b + USER_BATCH], rows[b: b + USER_BATCH]
        api.import_bits(ImportRequest("users", "seg", column_keys=[users[i] for i in c],
                                      row_keys=[segs[k] for k in r]))
    return users, cols, rows, time.perf_counter() - t0


def run_api_path(device, holder, engine, ex, host, seed, n_keys=USER_KEYS):
    """pilosa_tpu_torch.api.API on the card, every answer against numpy:
    keyed Counts on a field fk with row keys (K1; with field s, K2; 8 in
    one query, one K5), a keyed TopN (K3) and Options(shards=...,
    excludeColumns=...); an index users of ``n_keys`` column keys
    imported through API.import_bits, a keyed Row with its columns as
    keys and columnAttrs; SetRowAttrs on top and an attribute-filtered
    TopN (K3's scoring, the host walk); API.import_roaring into fk, then a
    keyed Count synced in place (S1).  The launch counters are zeroed just
    before the phase and read just after.  Prints the p50 of API.query
    against Executor.execute per operation and the import seconds."""
    import torch

    from pilosa_tpu_torch.api import API, ImportRequest, QueryRequest
    from pilosa_tpu_torch.parallel import kernels
    from pilosa_tpu_torch.roaring import codec

    cuda = device.type == "cuda"
    n_shards = len(host["f"][10])
    api = API(holder=holder, engine=engine)
    out = {"card": card_line()}
    t_phase = time.perf_counter()

    def q(text):
        return api.query(QueryRequest("bench", text)).results

    def check(what, got, want):
        if got != want:
            if isinstance(want, list) and len(want) > 8:
                diff = next(k for k, (x, y) in enumerate(zip(got, want)) if x != y) \
                    if len(got) == len(want) else None
                raise AssertionError(f"api: {what}: port {len(got)} items != numpy oracle "
                                     f"{len(want)} (first difference at {diff})")
            raise AssertionError(f"api: {what}: port {got} != numpy oracle {want}")

    t0 = time.perf_counter()
    ids, fk = build_keyed_field(api, holder, n_shards, seed)
    out["fk_fill_s"] = time.perf_counter() - t0
    log(f"api: field fk ({FK_ROWS} keyed rows x {n_shards} shards) filled in "
        f"{out['fk_fill_s']:.3f} s")
    zero_counts(COUNT_KERNELS + ("score_rows", "and_popcount_rows"))
    fallbacks0 = api.executor.host_fallbacks
    timed = {}  # query with keys -> the same query with ids, for the p50s

    with memo_off(engine):
        # Keyed Counts: K1 on fk, K2 with the block-clustered field s.
        a, b = ids["k03"], ids["k07"]
        ab = popcounts(fk[a] & fk[b])  # int64[S]
        for op, x, y, want in (("Intersect", "k03", "k07", int(ab.sum())),
                               ("Union", "k01", "k02", oracle(fk, "or", (ids["k01"], ids["k02"]))),
                               ("Difference", "k05", "k06",
                                oracle(fk, "andnot", (ids["k05"], ids["k06"])))):
            text = f'Count({op}(Row(fk="{x}"), Row(fk="{y}")))'
            check(text, q(text), [want])
            if engine.last_path != "dense":
                raise AssertionError(f"api: {text} took the {engine.last_path} path")
            timed[text] = f"Count({op}(Row(fk={ids[x]}), Row(fk={ids[y]})))"
        text = 'Count(Intersect(Row(fk="k03"), Row(s=10)))'
        check(text, q(text), [int(popcounts(fk[a] & host["s"][10]).sum())])
        if engine.last_path != "sparse":
            raise AssertionError(f"api: {text} took the {engine.last_path} path, not K2")
        timed[text] = f"Count(Intersect(Row(fk={a}), Row(s=10)))"
        pairs8 = [(ids[f"k{2 * k:02d}"], ids[f"k{2 * k + 1:02d}"]) for k in range(8)]
        text8 = "".join(f'Count(Intersect(Row(fk="k{2 * k:02d}"), Row(fk="k{2 * k + 1:02d}")))'
                        for k in range(8))
        before = _launch_counts()
        check("8 keyed Counts", q(text8), [int(popcounts(fk[x] & fk[y]).sum()) for x, y in pairs8])
        moved = {k: v - before[k] for k, v in _launch_counts().items()}
        if cuda and moved != {"count_tree_dense": 0, "count_tree_blocks": 0, "count_batch_tree": 1}:
            raise AssertionError(f"api: 8 keyed Counts launched {moved}, not one K5")
        timed[text8] = "".join(f"Count(Intersect(Row(fk={x}), Row(fk={y})))" for x, y in pairs8)
        # Options: a shard subset, and a Row with excludeColumns.
        sub = sorted(np.random.default_rng(seed + 13).choice(n_shards, n_shards // 2,
                                                             replace=False).tolist())
        inner = 'Count(Intersect(Row(fk="k03"), Row(fk="k07")))'
        text = f"Options({inner}, shards={sub})"
        check(text[:60], q(text), [int(ab[sub].sum())])
        timed[text] = f"Options(Count(Intersect(Row(fk={a}), Row(fk={b}))), shards={sub})"
        api.query(QueryRequest("bench", 'SetRowAttrs(fk, "k05", tier="gold")'))
        row = q('Options(Row(fk="k05"), excludeColumns=true)')[0]
        if row.columns().size or row.attrs != {"tier": "gold"}:
            raise AssertionError(f"api: excludeColumns gave {row.columns().size} columns, "
                                 f"attrs {row.attrs}")
        # A keyed TopN (K3), the result's row keys checked.
        key_of = {i: k for k, i in ids.items()}
        o = TopNOracle(fk)
        text = 'TopN(fk, Row(f=10), n=5)'
        want = [(key_of[r], c) for r, c in o.fused(host["f"][10], 5)]
        check(text, [tuple(p) for p in q(text)[0]], want)
        timed[text] = text
        # Row attributes on top, and the attribute-filtered TopN: the fused
        # lane declines it, K3 scores the candidates (both phases) and
        # Fragment.top filters them on the host.
        api.query(QueryRequest("bench", " ".join(
            f"SetRowAttrs(top, {r}, category={r % 4})" for r in TOP_ROWS)))
        k3 = kernels.score_rows_cuda.launches
        filtered = TopNOracle({r: w for r, w in host["top"].items() if r % 4 in (1, 2)})
        text = 'TopN(top, Row(f=11), n=5, attrName="category", attrValues=[1, 2])'
        check(text, [tuple(p) for p in q(text)[0]], filtered.two_phase(host["f"][11], 5))
        out["filtered_topn"] = {"k3_launches": kernels.score_rows_cuda.launches - k3,
                                "p2_launches": kernels.and_popcount_rows_cuda.launches,
                                "host_fallbacks": api.executor.host_fallbacks - fallbacks0}
        log(f"api: {text} exact; {json.dumps(out['filtered_topn'])}")
        if cuda and out["filtered_topn"]["k3_launches"] != 2:
            raise AssertionError(f"api: the filtered TopN: {out['filtered_topn']}")
        timed[text] = text

        # Column keys: index users, imported through API.import_bits.
        users, cols, rows, imp_s = import_users(api, n_keys, seed)
        out["users"] = {"keys": n_keys, "bits": int(cols.size), "import_bits_s": imp_s}
        log(f"api: {n_keys} column keys x {SEGS} keyed rows imported through API.import_bits "
            f"({cols.size} bits, translation included) in {imp_s:.3f} s"
            + ("" if n_keys == USER_KEYS else f" (cut from {USER_KEYS} keys)"))
        rng = np.random.default_rng(seed + 17)
        attr_cols = np.sort(rng.choice(n_keys, N_COL_ATTRS, replace=False))
        api.query(QueryRequest("users", " ".join(
            f'SetColumnAttrs("{users[c]}", tier={c % 5}, vip={"true" if c % 2 else "false"})'
            for c in attr_cols)))
        seg3 = np.unique(cols[rows == 3])
        want_keys = [users[c] for c in seg3]  # ids follow the keys' first import
        got = api.query(QueryRequest("users", 'Row(seg="seg3")')).results[0]
        check('Row(seg="seg3") keys', got.keys, want_keys)
        resp = api.query(QueryRequest("users", 'Options(Row(seg="seg3"), columnAttrs=true)'))
        want_sets = [{"key": users[c], "attrs": {"tier": int(c % 5), "vip": bool(c % 2)}}
                     for c in np.intersect1d(attr_cols, seg3)]
        check("columnAttrs", [s.to_dict() for s in resp.column_attr_sets], want_sets)
        seg_id = {s: i for s, i in zip(
            [f"seg{k}" for k in range(SEGS)],
            api.translate_keys("users", "seg", [f"seg{k}" for k in range(SEGS)]))}
        both = np.intersect1d(np.unique(cols[rows == 1]), np.unique(cols[rows == 2]))
        text = 'Count(Intersect(Row(seg="seg1"), Row(seg="seg2")))'
        check(text, api.query(QueryRequest("users", text)).results, [int(both.size)])
        # A keyed import into rows and shards the seg stack holds: synced
        # in place.
        upd0, reb0 = engine.stack_updates, engine.stack_rebuilds
        add = np.setdiff1d(np.unique(cols[rows == 1])[:5000], both)
        api.import_bits(ImportRequest("users", "seg", column_keys=[users[c] for c in add],
                                      row_keys=["seg2"] * add.size))
        engine.ingest_syncer().flush()
        check(text + " after a keyed import", api.query(QueryRequest("users", text)).results,
              [int(both.size + add.size)])
        out["users"]["keyed_import_sync"] = {"stack_updates": engine.stack_updates - upd0,
                                             "stack_rebuilds": engine.stack_rebuilds - reb0}
        if out["users"]["keyed_import_sync"] != {"stack_updates": 1, "stack_rebuilds": 0}:
            raise AssertionError(f"api: keyed import sync {out['users']['keyed_import_sync']}")
        log(f"api: keyed Row, columnAttrs ({len(want_sets)} sets) and Counts on users exact; "
            f"keyed import synced {json.dumps(out['users']['keyed_import_sync'])}")

        # API.import_roaring: 2^20 bits into one shard of fk (rows k03 and
        # k07), then the keyed Count, synced in place.
        sh = n_shards // 3
        rng = np.random.default_rng(seed + 19)
        half = 1 << 19
        new_cols = {r: np.sort(rng.choice(1 << 20, half, replace=False)) for r in (a, b)}
        old = {r: fk[r][sh].copy() for r in (a, b)}
        new = {r: old[r] | _words_of(new_cols[r]) for r in (a, b)}
        changed_want = sum(int(popcounts(new[r] & ~old[r])) for r in (a, b))
        want = int(ab.sum() - ab[sh] + popcounts(new[a] & new[b]))
        positions = np.concatenate([np.uint64(r << 20) + new_cols[r].astype(np.uint64)
                                    for r in sorted((a, b))])
        data = codec.serialize(positions)
        upd0, reb0 = engine.stack_updates, engine.stack_rebuilds
        t0 = time.perf_counter()
        changed = api.import_roaring("bench", "fk", sh, data)
        engine.ingest_syncer().flush()
        if cuda:
            torch.cuda.synchronize()
        out["import_roaring"] = {"bits": int(positions.size), "bytes": len(data),
                                 "changed": changed, "seconds": time.perf_counter() - t0}
        check("import_roaring bits changed", changed, changed_want)
        text = 'Count(Intersect(Row(fk="k03"), Row(fk="k07")))'
        check(text + " after import_roaring", q(text), [want])
        out["import_roaring"].update(stack_updates=engine.stack_updates - upd0,
                                     stack_rebuilds=engine.stack_rebuilds - reb0)
        log(f"api: import_roaring {json.dumps(out['import_roaring'])}")
        if (out["import_roaring"]["stack_updates"], out["import_roaring"]["stack_rebuilds"]) != (1, 0):
            raise AssertionError(f"api: import_roaring sync {out['import_roaring']}")

        # p50s: API.query against Executor.execute of the same query.
        times = {text: _api_p50s(text, by_id, api, ex, "bench") for text, by_id in timed.items()}
        uq = {'Row(seg="seg3")': f"Row(seg={seg_id['seg3']})",
              'Options(Row(seg="seg3"), columnAttrs=true)':
                  f"Options(Row(seg={seg_id['seg3']}), columnAttrs=true)",
              'Count(Intersect(Row(seg="seg1"), Row(seg="seg2")))':
                  f"Count(Intersect(Row(seg={seg_id['seg1']}), Row(seg={seg_id['seg2']})))"}
        for text, by_id in uq.items():
            times[text] = _api_p50s(text, by_id, api, ex, "users")
    launches = read_counts(COUNT_KERNELS + ("score_rows", "and_popcount_rows"))
    out["launches"] = launches
    out["p50"] = times
    for text, t in times.items():
        log(f"api: {text[:72]}: API.query p50 {t['api_p50_ms']:.4f} ms, Executor.execute "
            f"p50 {t['executor_p50_ms']:.4f} ms")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"api: launches {json.dumps(launches)}; host fallbacks "
        f"{api.executor.host_fallbacks - fallbacks0}; phase {out['seconds']:.3f} s; "
        f"{out['card']}")
    if cuda and (min(launches[k] for k in ("count_tree_dense", "count_tree_blocks",
                                           "count_batch_tree", "score_rows")) <= 0
                 or launches["and_popcount_rows"]):
        raise AssertionError(f"api: launches {launches}")
    if api.executor.host_fallbacks != fallbacks0:
        raise AssertionError("api: a Count fell back to the host lane")
    return out


# -- the fusion phase: whole-dashboard drains (bench.py:1372-1680) ----------

DASH_WIDGETS = (2, 4, 8, 10)  # bench.py DASH_WIDGETS
DASH_REPS = 24  # bench.py DASH_REPS
DASH_VALUES_PER_8 = 30_000  # v: bench.py's 30,000 values over 8 shards
DASH_SEG = "Intersect(Row(seg=0), Row(seg=1), Row(seg=2), Row(seg=3))"
# The widgets of bench.py _dash_entries as executor queries, in order (the
# TopN-scores widget is TopN(ids=...): a user asks for those rows' counts).
DASH_PQL = [
    f"Count(Intersect({DASH_SEG}, Row(w=1)))",
    f"Sum({DASH_SEG}, field=v)",
    f"TopN(w, {DASH_SEG}, n=5)",
    f"Min({DASH_SEG}, field=v)",
    f"Max({DASH_SEG}, field=v)",
    f"Count(Intersect({DASH_SEG}, Row(w=2)))",
    f"TopN(w, {DASH_SEG}, ids=[1, 2, 3, 4])",
    f"Count(Difference({DASH_SEG}, Row(w=3)))",
    f"GroupBy(Rows(field=g), filter={DASH_SEG})",
    f"TopN(w, Intersect({DASH_SEG}, Row(w=4)), n=3)",
]


def dash_entries(n, shards):
    """bench.py's _dash_entries: 1 segment filter x ``n`` widgets."""
    from pilosa_tpu_torch import pql

    P = lambda q: pql.parse(q).calls[0]  # noqa: E731
    segc = lambda: P(DASH_SEG)  # noqa: E731
    return [
        ({"kind": "count", "call": P(f"Intersect({DASH_SEG}, Row(w=1))")}, shards),
        ({"kind": "sum", "field": "v", "filter": segc()}, shards),
        ({"kind": "topnf", "field": "w", "src": segc(), "n": 5, "threshold": 1,
          "row_ids": None}, shards),
        ({"kind": "min", "field": "v", "filter": segc()}, shards),
        ({"kind": "max", "field": "v", "filter": segc()}, shards),
        ({"kind": "count", "call": P(f"Intersect({DASH_SEG}, Row(w=2))")}, shards),
        ({"kind": "topn", "field": "w", "rows": [1, 2, 3, 4], "src": segc()}, shards),
        ({"kind": "count", "call": P(f"Difference({DASH_SEG}, Row(w=3))")}, shards),
        ({"kind": "group", "fields": ["g"], "rows": [[0, 1, 2, 3]], "filter": segc()},
         shards),
        ({"kind": "topnf", "field": "w", "src": P(f"Intersect({DASH_SEG}, Row(w=4))"),
          "n": 3, "threshold": 1, "row_ids": None}, shards),
    ][:n]


def build_dash(holder, name, n_shards, rng, with_g=True):
    """bench.py's dashboard index: seg 4 rows rand | rand, w rows 1-4 rand,
    g 4 rows rand (``with_g``), v an int field 0..100 holding index % 100 at
    30,000 random columns per 8 shards (its bit planes loaded directly, as
    build_bsi_fields does).  Returns ({field: {row: uint64[S, W64]}}, cols,
    values): copies of what the fragments hold."""
    from pilosa_tpu_torch.core.field import FieldOptions

    idx = holder.create_index(name)
    host = {"seg": {r: _rand64(rng, n_shards) | _rand64(rng, n_shards) for r in range(4)},
            "w": {r: _rand64(rng, n_shards) for r in range(1, 5)}}
    if with_g:
        host["g"] = {r: _rand64(rng, n_shards) for r in range(4)}
    for field, rows in host.items():
        view = idx.create_field(field).view_if_not_exists("standard")
        for sh in range(n_shards):
            frag = view.fragment_if_not_exists(sh)
            for r, words in rows.items():
                frag.load_row_words(r, words[sh].copy())
            frag.cache.invalidate()
    n_vals = DASH_VALUES_PER_8 * n_shards // 8
    cols = np.sort(rng.choice(n_shards << 20, n_vals, replace=False)).astype(np.int64)
    vals = np.arange(n_vals, dtype=np.int64) % 100
    v = idx.create_field("v", FieldOptions(type="int", min=0, max=100))
    depth = v.bsi_group("v").bit_depth()
    planes = {}
    for i in range(depth + 1):
        on = cols if i == depth else cols[(vals >> i) & 1 == 1]
        words = np.zeros(n_shards * W64, dtype=np.uint64)
        np.bitwise_or.at(words, on >> 6, np.uint64(1) << (on & 63).astype(np.uint64))
        planes[i] = words.reshape(n_shards, W64)
    for sh in range(n_shards):
        frag = v.view_if_not_exists("bsig_v").fragment_if_not_exists(sh)
        for i, words in planes.items():
            frag.load_row_words(i, words[sh].copy())
        frag.cache.invalidate()
    return host, cols, vals


def _rand64(rng, n_shards):
    return rng.integers(0, 1 << 64, (n_shards, W64), dtype=np.uint64)


class DashOracle:
    """Every widget's answer from the host words with numpy."""

    def __init__(self, host, cols, vals):
        self.host, self.cols, self.vals = host, cols, vals
        seg = host["seg"][0] & host["seg"][1] & host["seg"][2] & host["seg"][3]
        self.seg = seg
        flat = seg.reshape(-1)
        on = (flat[cols >> 6] >> (cols & 63).astype(np.uint64)) & np.uint64(1) == 1
        self.seg_vals = vals[on]
        self.seg_shard = cols[on] >> 20
        self.topn = TopNOracle(host["w"])
        self._want = {}

    def _minmax(self, is_min):
        """The reference's ValCount reduce: each shard's extreme and its
        count there, shards in order, the first shard's count on a tie."""
        best, n = 0, 0
        for sh in np.unique(self.seg_shard):
            v = self.seg_vals[self.seg_shard == sh]
            x = int(v.min() if is_min else v.max())
            if n == 0 or (x < best if is_min else x > best):
                best, n = x, int((v == x).sum())
        return (best, n)

    def want(self, k):
        """Widget k's result as TorchEngine returns it (fused_many), computed
        once."""
        if k not in self._want:
            self._want[k] = self._compute(k)
        return self._want[k]

    def _compute(self, k):
        h, seg = self.host, self.seg
        if k in (0, 5):
            return int(popcounts(seg & h["w"][1 + k // 5]).sum())
        if k == 1:
            return (int(self.seg_vals.sum()), int(self.seg_vals.size))
        if k == 2:
            return self.topn.fused(seg, 5)
        if k in (3, 4):
            return self._minmax(k == 3)
        if k == 6:
            return np.stack([popcounts(h["w"][r] & seg) for r in (1, 2, 3, 4)], axis=1), \
                popcounts(seg)
        if k == 7:
            return int(popcounts(seg & ~h["w"][3]).sum())
        if k == 8:
            return np.asarray([int(popcounts(h["g"][r] & seg).sum()) for r in range(4)])
        return self.topn.fused(seg & h["w"][4], 3)

    def want_pql(self, k):
        """Widget k's result as Executor.execute returns it (DASH_PQL)."""
        if k == 6:
            if "ids" not in self._want:
                self._want["ids"] = self.topn.fused(self.seg, 0, ids=[1, 2, 3, 4])
            return self._want["ids"]
        if k == 8:
            return [(r, int(c)) for r, c in enumerate(self.want(8)) if c > 0]
        return self.want(k)


def _dash_same(got, want, what):
    if isinstance(want, tuple) and len(want) == 2 and isinstance(want[0], np.ndarray):
        scores, counts, pos = got
        order = [pos[s] for s in sorted(pos)]
        ok = np.array_equal(scores[order], want[0]) and np.array_equal(
            np.asarray(counts)[order], want[1])
    elif isinstance(want, np.ndarray):
        ok = np.array_equal(np.asarray(got).reshape(-1), want)
    else:
        ok = got == want
    if not ok:
        raise AssertionError(f"fusion: {what}: port {got!r} != numpy oracle {want!r}")


def _pql_result(res):
    """An Executor result in DashOracle.want_pql's form."""
    if hasattr(res, "val") and hasattr(res, "count") and not isinstance(res, list):
        return (res.val, res.count)
    if isinstance(res, list) and res and hasattr(res[0], "group"):
        return [(g.group[0].row_id, g.count) for g in res]
    if isinstance(res, list):
        return [tuple(p) for p in res]
    return res


def f1_work(code, n_shards, n_mat, n_counted):
    """(bytes, (integer ops, popcounts)) of one F1 launch over every shard:
    each leaf row (and each range leaf's planes) read once, each
    materialized slot written once; a 32-bit operation per word for each
    item and slot reference, and a popcount per word of each counted
    slot."""
    rows = len(code.leaves) + sum(len(r[2]) for r in code.ranges) + n_mat
    byts = rows * n_shards * W64 * 8
    words = n_shards * W64 * 2
    return byts, (words * (len(code.items) + sum(bin(m).count("1") for m in code.mref)),
                  words * n_counted)


def run_fusion_path(device, holder, engine, ex, seed, err, n_shards=N_SHARDS):
    """The fusion phase, after api and before the writes of phase 5: index
    dash (bench.py's dashboard at ``n_shards``) and dash2 (its cross-index
    twin); the widgets at N in DASH_WIDGETS through engine.fused_many
    against the sequential per-op path, through Executor.execute from N
    threads at once, and bench.py's cross-index drain, every answer against
    numpy, the memo off; F1's launches counted from zero just before and
    read just after, fused_programs moving in the executor's part, F1 on
    the card there (torch.profiler); one Set into seg, the plan rebuilt and
    the drain exact; F1 at the 10-widget shape against its plain version
    and its bound.  Returns the phase's numbers and F1's kernel entry."""
    import threading

    import torch

    from pilosa_tpu_torch.parallel import kernels

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {"card": card_line()}
    t_phase = t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 3)  # 23 at the default seed: bench.py's
    host, cols, vals = build_dash(holder, "dash", n_shards, rng)
    host2, cols2, vals2 = build_dash(holder, "dash2", n_shards, rng, with_g=False)
    shards = list(range(n_shards))
    for name, fields in (("dash", ("seg", "w", "g")), ("dash2", ("seg", "w"))):
        for f in fields:
            engine.field_stack(name, f, "standard")
        engine.field_stack(name, "v", "bsig_v")
    sync()
    out["made_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ora, ora2 = DashOracle(host, cols, vals), DashOracle(host2, cols2, vals2)
    out["oracle_s"] = time.perf_counter() - t0
    log(f"fusion: indexes dash and dash2 ({n_shards} shards, "
        f"{(12 + 8 + 8 + 8) * n_shards * W64 * 8 / 1e9:.2f} GB of stacks) made in "
        f"{out['made_s']:.3f} s; numpy oracle {out['oracle_s']:.3f} s")
    names = ("fused_tree", "sum_tree", "minmax_tree", "score_rows", "groupn_tree",
             "count_tree_dense")

    def launches():
        return read_counts(names)

    seq_lat = {}
    with memo_off(engine):
        # The main path: every drain once with F1's counter zeroed just
        # before; then the p50s (bench.py's sync_p50 reps).
        zero_counts(names)
        p0 = engine.fused_programs
        per_drain = {}
        for n in DASH_WIDGETS:
            entries = dash_entries(n, shards)
            before = launches()
            got = engine.fused_many("dash", entries)
            per_drain[n] = {k: v - before[k] for k, v in launches().items()}
            seq = [engine.solo_op("dash", sp["kind"], sp, sh) for sp, sh in entries]
            for k in range(n):
                _dash_same(got[k], ora.want(k), f"N={n} widget {k} fused")
                _dash_same(seq[k], ora.want(k), f"N={n} widget {k} sequential")
        f1_main = kernels.fused_tree_cuda.launches
        if engine.fused_programs - p0 != len(DASH_WIDGETS) or (cuda and f1_main != len(
                DASH_WIDGETS)):
            raise AssertionError(f"fusion: {len(DASH_WIDGETS)} drains made "
                                 f"{engine.fused_programs - p0} programs, {f1_main} F1 launches")
        out["launches_per_drain"] = per_drain
        log(f"fusion: N in {DASH_WIDGETS} exact against numpy (fused and sequential); "
            f"launches per drain {json.dumps(per_drain)}")
        reps = DASH_REPS if cuda else 1  # the CPU rehearsal runs the plain versions
        for n in DASH_WIDGETS:
            entries = dash_entries(n, shards)
            lat = []
            for _ in range(reps):
                t1 = time.perf_counter()
                engine.fused_many("dash", entries)
                lat.append(time.perf_counter() - t1)
            slat = []
            for _ in range(max(4, reps // 2) if cuda else 1):
                t1 = time.perf_counter()
                for sp, sh in entries:
                    engine.solo_op("dash", sp["kind"], sp, sh)
                slat.append(time.perf_counter() - t1)
            t_f, t_s = statistics.median(lat), statistics.median(slat)
            seq_lat[n] = t_s
            out[f"dashboard_fused_qps_n{n}"] = n / t_f
            out[f"dashboard_seq_qps_n{n}"] = n / t_s
            out[f"dashboard_speedup_n{n}"] = t_s / t_f
            if n == 8:
                out["dashboard_fused_qps"] = 8 / t_f
                out["dashboard_p50_ms"] = t_f * 1e3
                out["dashboard_fused_speedup"] = t_s / t_f
        log("fusion: " + ", ".join(f"{k} {out[k]:.4f}" for k in (
            "dashboard_fused_qps", "dashboard_p50_ms", "dashboard_fused_speedup")))

        # Executor.execute from N threads at once, each widget one query,
        # the batcher hot so that every aggregate queues into one drain (a
        # Count runs on its own launch: the executor's Count lane calls the
        # engine directly, so N = 2, one Count and one Sum, fuses nothing).
        b = engine.batcher()
        ex_runs = {}

        def executor_dashboard(n):
            barrier = threading.Barrier(n)
            res = [None] * n
            q_ms = [0.0] * n

            def run(k):
                barrier.wait()
                t1 = time.perf_counter()
                res[k] = ex.execute("dash", DASH_PQL[k]).results[0]
                q_ms[k] = (time.perf_counter() - t1) * 1e3

            b._last_fused = time.monotonic() + 3600
            threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
            try:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(120)
            finally:
                b._last_fused = 0.0
            for k in range(n):
                _dash_same(_pql_result(res[k]), ora.want_pql(k), f"executor N={n} {DASH_PQL[k]}")
            return q_ms

        for n in DASH_WIDGETS:
            p0, f0 = engine.fused_programs, kernels.fused_tree_cuda.launches
            fb0 = ex.host_fallbacks
            per_q = [executor_dashboard(n) for _ in range(3)]
            # The dashboard's latency: until its last widget answered.
            ex_runs[n] = {"dashboard_ms_p50": statistics.median(max(q) for q in per_q),
                          "query_ms_p50": [statistics.median(q[k] for q in per_q)
                                           for k in range(n)],
                          "fused_programs": engine.fused_programs - p0,
                          "f1_launches": kernels.fused_tree_cuda.launches - f0,
                          "host_fallbacks": ex.host_fallbacks - fb0}
            aggs = sum(1 for q in DASH_PQL[:n] if not q.startswith("Count("))
            if ex_runs[n]["host_fallbacks"] or (aggs >= 2 and (
                    ex_runs[n]["fused_programs"] < 1 or (cuda and ex_runs[n]["f1_launches"] < 1))):
                raise AssertionError(f"fusion: executor N={n}: {ex_runs[n]}")
        out["executor"] = ex_runs
        out["executor_pipeline"] = b.pipeline_snapshot()["stages"]
        log(f"fusion: Executor.execute from N threads exact; {json.dumps(ex_runs)}")
        if cuda:
            seen = on_card(lambda: executor_dashboard(10),
                           lambda seen: any("fused_tree_kernel" in k for k in seen))
            if not any("fused_tree_kernel" in k for k in seen):
                raise AssertionError(f"fusion: the executor's dashboard put no F1 on the "
                                     f"card: {sorted(seen)}")
            out["executor_on_card"] = per_launch(seen)

        # bench.py's cross-index drain: one part per index.
        xs = [("dash", 0), ("dash2", 0), ("dash", 2), ("dash2", 1), ("dash", 8), ("dash2", 2)]
        entries_x = [(name, dash_entries(10, shards)[k][0], shards) for name, k in xs]
        f0 = kernels.fused_tree_cuda.launches
        got = engine.fused_drain(entries_x)
        if cuda and kernels.fused_tree_cuda.launches - f0 != 2:
            raise AssertionError("fusion: the cross-index drain did not launch F1 per index")
        for (name, k), g in zip(xs, got):
            _dash_same(g, (ora if name == "dash" else ora2).want(k), f"cross-index {name} {k}")
        lat = []
        for _ in range(reps):
            t1 = time.perf_counter()
            engine.fused_drain(entries_x)
            lat.append(time.perf_counter() - t1)
        out["dashboard_crossindex_p50_ms"] = statistics.median(lat) * 1e3
        log(f"fusion: cross-index drain exact; dashboard_crossindex_p50_ms "
            f"{out['dashboard_crossindex_p50_ms']:.4f}")

        # One Set into seg: the stack syncs in place, the plan rebuilds,
        # the drain stays exact.
        h = ora.host
        both = h["seg"][1] & h["seg"][2] & h["seg"][3] & h["w"][1] & ~h["seg"][0]
        sh, word = map(int, np.argwhere(both != 0)[0])
        bit = int(both[sh, word]).bit_length() - 1
        col = (sh << 20) + word * 64 + bit
        miss0, upd0, reb0 = engine.fused_plan_misses, engine.stack_updates, engine.stack_rebuilds
        ex.execute("dash", f"Set({col}, seg=0)")
        h["seg"][0][sh, word] |= np.uint64(1) << np.uint64(bit)
        ora = DashOracle(h, cols, vals)
        got = engine.fused_many("dash", dash_entries(10, shards))
        for k in range(10):
            _dash_same(got[k], ora.want(k), f"after Set({col}, seg=0), widget {k}")
        moved = {"plan_misses": engine.fused_plan_misses - miss0,
                 "stack_updates": engine.stack_updates - upd0,
                 "stack_rebuilds": engine.stack_rebuilds - reb0}
        if moved != {"plan_misses": 1, "stack_updates": 1, "stack_rebuilds": 0}:
            raise AssertionError(f"fusion: after one Set: {moved}")
        out["after_set"] = moved
        log(f"fusion: Set({col}, seg=0) then the 10-widget drain exact; {json.dumps(moved)}")

    # F1 at the 10-widget shape, alone, against its plain version and bound.
    entry = None
    from pilosa_tpu_torch.parallel import fusion

    with engine._stacks_lock:
        part = fusion.build(engine, [("dash", sp, sh) for sp, sh in
                                     dash_entries(10, shards)]).parts[0]
    spec = part.spec
    code = spec.code()
    gates = [part.masks[m] for _, m in spec.count_edges]
    cslots = [j for j, _ in spec.count_edges]

    def f1():
        return kernels.fused_tree_cuda(code, part.lw.mats, cslots, gates, spec.mat_slots,
                                       part.need)

    def f1_plain():
        vals_p = kernels.fused_slots_plain(spec.slots, part.lw.mats, (n_shards, 32768), device)
        return [bitops_popcount(vals_p[j], g) for j, g in zip(cslots, gates)], vals_p

    if cuda:
        counts, mat = f1()
        want_counts, vals_p = f1_plain()
        sync()
        e = _exact("F1", counts, torch.stack(want_counts).to(torch.int64),
                   "at the 10-widget shape: counts")
        for i, j in enumerate(spec.mat_slots):
            e = max(e, _exact("F1", mat[i], vals_p[j], f"at the 10-widget shape: slot {j}"))
        err["fused_tree"] = max(err.get("fused_tree", 0), e)
        del vals_p
        byts, ops = f1_work(code, n_shards, len(spec.mat_slots), len(set(cslots)))
        bound = least_ms(byts, ops)
        for _ in range(3):
            f1()
        sync()
        t = measured(f1, "fused_tree_kernel", sync, bound_ms=bound)
        plain = p50_ms(f1_plain, 3, sync, batch=1)
        _times_line(f"F1 fused_tree at the 10-widget shape ({len(spec.slots)} slots, "
                    f"{len(code.op)} of them in F1, {len(code.leaves)} leaf rows, "
                    f"{len(spec.count_edges)} count edges, {len(spec.mat_slots)} "
                    "materialized)", t, bound, plain,
                    f"; {bound / t['device_ms'] * 100:.1f}% of the bound")
        entry = _entry("fused_tree", "pilosa_tpu_torch/csrc/fused_tree.cu",
                       "pilosa_tpu/parallel/kernels.py:545 fused_tree", f1_main,
                       err["fused_tree"], t, plain, byts, ops, None)
        entry["shape"] = (f"10-widget dashboard, {n_shards} shards: {len(spec.slots)} slots "
                          f"({len(code.op)} in F1), {len(code.leaves)} leaf rows, "
                          f"{len(spec.count_edges)} count edges, "
                          f"{len(spec.mat_slots)} slots materialized")
        entry["launches_per_drain"] = per_drain
        out["f1"] = {"device_ms": t["device_ms"], "bound_ms": bound, "ms": t["ms"],
                     "host_us": t["host_us"], "plain_ms": plain, "launches": f1_main,
                     "launches_per_drain_n10": per_drain[10]}
        log(f"fusion: F1 device_ms {t['device_ms']:.4f}, bound_ms {bound:.4f}, launches "
            f"{f1_main} on the main path, per 10-widget drain {json.dumps(per_drain[10])}; "
            f"{card_line()}")
    out["wall_s"] = time.perf_counter() - t_phase
    return out, entry


# -- residency: the index 4x the device budget (bench.py:2094-2260) ---------

RSW_FIELDS = 4  # bench.py RSW_FIELDS
RSW_ROWS = 32  # bench.py RSW_ROWS: rows per field
RSW_BLOCKS = 8  # bench.py RSW_BLOCKS: occupied blocks of 64 per row and shard
RSW_WARM_REPS = 40  # bench.py RSW_WARM_REPS
RSW_SEED = 11  # bench.py residency_sweep's rng
RSW_ROTATIONS = range(8, 22, 2)  # working sets rotated in after the checks
ROW_SHARD_BYTES = 32768 * 4 + 16  # engine.ROW_SHARD_BYTES (budget units)


def build_rsw(holder, n_shards, seed=RSW_SEED):
    """bench.py's residency-sweep index at ``n_shards`` shards: fields
    wf0..wf3 of 32 rows, each row rand & rand in its first 8 occupancy blocks
    of every shard (the rest zero); field rt, 4 rows of random words in the
    same blocks (TopN candidates), and rv, an int field 0..100 on 64
    columns of each shard's first 8 blocks.  Rows are loaded as words
    (load_row_words keeps each array: the zero blocks stay untouched pages).
    Returns {field: uint64[rows, S, W64]} and rv's (columns, values)."""
    from pilosa_tpu_torch.core.field import FieldOptions

    rng = np.random.default_rng(seed)
    W64 = 16384
    nw = RSW_BLOCKS * 256  # uint64 words of the occupied blocks
    idx = holder.create_index("rsw")
    words = {}
    for name, rows in [(f"wf{fi}", RSW_ROWS) for fi in range(RSW_FIELDS)] + [("rt", 4)]:
        arr = np.zeros((rows, n_shards, W64), dtype=np.uint64)
        for r in range(rows):
            a = rng.integers(0, 1 << 64, (n_shards, nw), dtype=np.uint64)
            if name != "rt":
                a &= rng.integers(0, 1 << 64, (n_shards, nw), dtype=np.uint64)
            arr[r, :, :nw] = a
        view = idx.create_field(name).view_if_not_exists("standard")
        for s in range(n_shards):
            frag = view.fragment_if_not_exists(s)
            for r in range(rows):
                frag.load_row_words(r, arr[r, s])
            frag.cache.invalidate()
        words[name] = arr
    cols = (np.arange(n_shards, dtype=np.int64)[:, None] << 20) + rng.integers(
        0, nw * 64, (n_shards, 64))
    cols = np.unique(cols.reshape(-1))
    vals = cols % 101
    idx.create_field("rv", FieldOptions(type="int", min=0, max=100)).import_values(
        cols.tolist(), vals.tolist())
    return words, (cols, vals)


def _bit_of(arr, row, cols):
    """The bits of row ``row`` of uint64[rows, S, W64] at columns ``cols``."""
    s, c = cols >> 20, cols & ((1 << 20) - 1)
    return (arr[row, s, c >> 6] >> (c & 63).astype(np.uint64)) & np.uint64(1)


@contextlib.contextmanager
def _path_counts_kept():
    """Put back, on leaving, every kernel wrapper's launch count and the
    pool leaf's counts: the launches inside (checks, timing windows) are
    not the path's."""
    from pilosa_tpu_torch.parallel import bsi, groupby, kernels, sparse

    fns = (kernels.count_tree_dense, kernels.count_tree_pool, sparse.count_tree_blocks_cuda,
           kernels.score_rows_cuda, kernels.score_rows_pool_cuda, kernels.count_batch_tree_cuda,
           kernels.count_batch_tree_pool_cuda, bsi.sum_tree_cuda, bsi.sum_tree_pool_cuda,
           bsi.minmax_tree_cuda, bsi.minmax_tree_pool_cuda, groupby.groupn_tree_cuda,
           groupby.groupn_tree_pool_cuda, kernels.fused_tree_cuda,
           kernels.fused_tree_pool_cuda, kernels.range_leaf, kernels.pool_leaf)
    saved = [f.launches for f in fns], dict(kernels.pool_leaf.by_kernel)
    try:
        yield
    finally:
        for f, n in zip(fns, saved[0]):
            f.launches = n
        kernels.pool_leaf.by_kernel.clear()
        kernels.pool_leaf.by_kernel.update(saved[1])


def live_leaf_bytes(prog, mats, mask):
    """The bytes K1P must read for a tree: each leaf's live blocks (a pool
    leaf's where its slot is not 0 too; a range leaf's planes) over the
    requested shards, 2 KiB each, and the mask and the result."""
    from pilosa_tpu_torch.parallel import kernels

    live = kernels.live_blocks(prog, mats, mask.device)
    n_live = int(live.sum())
    code = kernels.compile_prog(prog)
    blocks = sum(int((live & (mats[leaf[2]][leaf[1]] != 0)).sum()) if len(leaf) == 3 else n_live
                 for leaf in code.leaves)
    blocks += sum(sum(1 for p in planes if p >= 0) * n_live for _, _, planes, _, _ in code.ranges)
    return blocks * int((mask != 0).sum()) * 2048 + mask.numel() * 4 + 8


def minmax_live_bytes(prog, mats, mask, plane_mat, planes, leaf_bytes):
    """The bytes K7P must read for a Min/Max under filter ``prog``: its
    leaves (``leaf_bytes``), the not-null plane at the filter's live
    blocks, and the value planes only in the 32-byte sectors that hold a
    considered column (the word-local walk reads no value plane where
    notnull & filter is zero), over the requested shards; from this run's
    data."""
    from pilosa_tpu_torch.parallel import kernels

    idx, select = kernels.live_select(prog, mats, mask.device)
    if idx.numel() == 0 or planes[-1] < 0:
        return leaf_bytes
    req = mask != 0
    notnull = select(plane_mat[planes[-1]])[req]
    cons = kernels.eval_prog(prog, mats, select, blocks=idx)[req] & notnull
    sectors = int((cons.reshape(-1, 8) != 0).any(dim=1).sum())
    return (leaf_bytes + notnull.numel() * 4
            + sectors * 32 * sum(1 for p in planes[:-1] if p >= 0))


def call_kernels_ms(fn, names, reps=10, bound_ms=None):
    """The device time of one call of ``fn``, kernel by kernel, from
    torch.profiler over ``reps`` calls: {"device_ms": the sum over every
    kernel (copies aside), "kernels": {name: [launches, ms] per call}}.  A
    window where a kernel of ``names`` shows fewer than ``reps`` launches,
    or the sum reads below ``bound_ms`` (records the profiler lost, or
    times it halved), is taken again (on_card); the last window stands,
    with a log line if it still reads so."""
    def per_call(seen):
        return {k: [n / reps, t / reps] for k, (n, t) in seen.items()
                if not k.startswith(("Memcpy", "Memset"))}

    def full(seen):
        return (all(sum(v[0] for k, v in seen.items() if n in k) >= reps for n in names)
                and (bound_ms is None or sum(t for _, t in per_call(seen).values()) >= bound_ms))

    seen = on_card(lambda: [fn() for _ in range(reps)], full)
    if not full(seen):
        log(f"times: {names} short or below {bound_ms} ms in every window: {seen}")
    ks = per_call(seen)
    return {"device_ms": sum(t for _, t in ks.values()), "kernels": ks}


def pool_leaf_in(eng, ex, holder, entries, seg, S):
    """The pool leaf inside K3P (TopN(rt, Row(wf1=2))) and K6P (Sum over
    the seg filter): device ms per call for K3P, per launch for K6P,
    against the bytes of the blocks the query can read (a src or filter's
    live blocks for K3P's candidates and K6P's planes).  And "drain": every
    kernel of one fused_many call (F1P, then its K6P, K3P, K7P and K8P
    edges, and the wrapper's small fills) against the live bytes of the
    leaves and slots F1P reads and writes and of the slot, planes,
    candidates and group rows its edges read.  K5P and F1P alone are timed
    through their wrappers (pool_batch_and_drain)."""
    st = {f: eng._stacks[("rsw", f, "standard")] for f in ("wf0", "wf1")}

    def occ(f, r):
        return int(np.count_nonzero(st[f].slot_of[r]))

    blk = S * 2048
    seg_live = int(np.count_nonzero((st["wf0"].slot_of[0] != 0) & (st["wf0"].slot_of[1] != 0)))
    src_live = occ("wf1", 2)
    planes = holder.index("rsw").field("rv").bit_depth() + 1
    f1_blocks = occ("wf0", 0) + occ("wf0", 1) + src_live + seg_live + src_live
    items = {
        "k3": (lambda: ex.execute("rsw", "TopN(rt, Row(wf1=2), n=3)"), "score_rows",
               (1 + 4) * src_live),
        "k6": (lambda: ex.execute("rsw", f"Sum({seg}, field=rv)"), "sum_tree",
               (2 + planes) * seg_live),
    }
    out = {}
    for name, (fn, kernel, blocks) in items.items():
        byts = blocks * blk
        out[name] = {"device_ms": device_ms(fn, kernel, per_call=name == "k3"),
                     "live_bytes": byts, "bound_ms": byts / HBM_BYTES_PER_S * 1e3}
    # The edges: K6P's slot and planes, K3P's slot and 4 candidates, K8P's
    # slot and rt's 4 rows, and K7P's slot, not-null plane and the value
    # planes' sectors that hold a considered column (minmax_live_bytes).
    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel.engine import _Lowering

    canonical = eng.canonical_shards("rsw")
    lw = _Lowering(eng, canonical)
    vst = eng._stacks[("rsw", "rv", "bsig_rv")]
    k7_bytes = minmax_live_bytes(
        eng._lower("rsw", pql.parse(seg).calls[0], lw), lw.mats,
        eng._mask_words(list(range(S)), canonical), vst.matrix,
        eng._plane_spec(vst, planes - 1), seg_live * blk)
    byts = (f1_blocks + (1 + planes) * seg_live + (1 + 4) * src_live
            + (1 + 4) * seg_live) * blk + k7_bytes
    bound = byts / HBM_BYTES_PER_S * 1e3
    out["drain"] = {**call_kernels_ms(lambda: eng.fused_many("rsw", entries),
                                      ("fused_tree_pool", "sum_tree_pool", "score_rows_pool",
                                       "minmax_tree_pool", "groupn_tree_pool"), bound_ms=bound),
                    "live_bytes": byts, "bound_ms": bound}
    log(f"residency: the pool leaf in K3P, K6P and the whole drain: {json.dumps(out)}")
    return out


def pool_batch_and_drain(eng, q8, entries, S):
    """K5P and F1P through their wrappers with the engine's own arguments
    (its lowering of the 8-Count query's trees and mask table; fusion's
    plan of the residency drain): each exact against both plain versions
    (F1P's pool and table against fused_mat_pool_plain, block for block),
    then their times (``measured``) against the bytes of the live blocks
    they read (and F1P writes), beside K5's and F1's whole-row walks over
    the same arguments and the pool plain versions' p50.  Returns {"k5p",
    "f1p"}."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel import fusion, kernels
    from pilosa_tpu_torch.parallel.engine import _Lowering

    sync = torch.cuda.synchronize
    device = torch.device("cuda")
    canonical = eng.canonical_shards("rsw")
    lw = _Lowering(eng, canonical)
    progs = [eng._lower("rsw", c.children[0], lw) for c in pql.parse(q8).calls]
    masks, ids = eng._mask_table([list(range(S))] * len(progs), canonical)
    batch = kernels.compile_batch(progs, ids)
    assert batch.pooled
    got = kernels.count_batch_tree_pool_cuda(batch, lw.mats, masks, device)
    for plain in (kernels.count_batch_tree_pool_plain, kernels.count_batch_tree_plain):
        _exact("count_batch_tree_pool", got, plain(progs, lw.mats, masks, ids, device),
               f"the residency 8-Count batch against {plain.__name__}")
    # Pool rows beside a range leaf (planes of a depth-7 stack like rv's,
    # random words): K5P stages the planes, stack rows live in every block,
    # beside the pool rows' live blocks.
    bst = _bsi_stack(np.random.default_rng(S), 7, S, device, extra=0)
    mats_r = list(lw.mats) + [bst]
    rg = _range_leaf("gt", tuple(range(8)), 50, 0, slot=len(lw.mats))
    progs_r = [("and", progs[0], rg), ("or", progs[1], rg), ("andnot", rg, progs[2])]
    batch_r = kernels.compile_batch(progs_r, ids[:3])
    assert batch_r.pooled and batch_r.ranges.shape[0] == 1
    got = kernels.count_batch_tree_pool_cuda(batch_r, mats_r, masks, device)
    for plain in (kernels.count_batch_tree_pool_plain, kernels.count_batch_tree_plain):
        _exact("count_batch_tree_pool", got, plain(progs_r, mats_r, masks, ids[:3], device),
               f"pool rows beside a range leaf against {plain.__name__}")
    log(f"residency: K5P with pool rows beside a range leaf exact ({S} shards, "
        f"{len(batch_r.leaves)} table rows)")
    del bst, mats_r
    def live(leaf, mats):  # a pool leaf's occupied blocks; a stack row's every block
        return int((mats[leaf[2]][leaf[1]] != 0).sum()) if len(leaf) == 3 else 64

    byts = sum(live(leaf, lw.mats) for leaf in batch.leaves) * S * 2048
    bound = byts / HBM_BYTES_PER_S * 1e3
    out = {"k5p": {**measured(lambda: kernels.count_batch_tree_pool_cuda(batch, lw.mats, masks,
                                                                          device),
                              "count_batch_tree_pool", sync, bound_ms=bound),
                   "bound_ms": bound, "bytes": byts,
                   "plain_ms": p50_ms(lambda: kernels.count_batch_tree_pool_plain(
                       progs, lw.mats, masks, ids, device), 3, sync, batch=1),
                   "k5_whole_row": measured(lambda: kernels.count_batch_tree_cuda(
                       batch, lw.mats, masks, device), "count_batch_tree_kernel", sync)}}
    with eng._stacks_lock:
        part = fusion.build(eng, [("rsw", sp, sh) for sp, sh in entries]).parts[0]
    spec, mats = part.spec, part.lw.mats
    code = spec.code()
    assert code.pooled
    cslots = [j for j, _ in spec.count_edges]
    gates = [part.masks[m] for _, m in spec.count_edges]
    args = (code, mats, cslots, gates, spec.mat_slots, part.need)
    counts, (fpool, ftable) = kernels.fused_tree_pool_cuda(*args)
    wpool, wtable = kernels.fused_mat_pool_plain(spec, mats, part.masks)
    vals = kernels.fused_slots_plain(spec.slots, mats, (S, 32768), device)
    _exact("fused_tree_pool", counts, torch.stack([
        bitops_popcount(vals[j], g) for j, g in zip(cslots, gates)]).to(torch.int64),
           "the residency drain's counts")
    _exact("fused_tree_pool", ftable, wtable, "the residency drain's table")
    named = torch.unique(wtable[wtable != 0]).long()
    _exact("fused_tree_pool", fpool[named], wpool[named], "the residency drain's pool rows")
    del vals, wpool
    n_live = int((wtable != 0).sum())  # the materialized slots' live blocks
    reads = sum(live(leaf, mats) for leaf in code.leaves)
    byts = (reads + n_live) * S * 2048
    bound = byts / HBM_BYTES_PER_S * 1e3
    f1_plain = kernels.FusedSpec(spec.slots, spec.count_edges, [])
    out["f1p"] = {**measured(lambda: kernels.fused_tree_pool_cuda(*args), "fused_tree_pool",
                             sync, bound_ms=bound),
                  "bound_ms": bound, "bytes": byts, "slots": len(code.op),
                  "leaves": len(code.leaves), "written_blocks": n_live,
                  "plain_ms": p50_ms(lambda: (kernels.fused_tree_pool_plain(
                      f1_plain, mats, part.masks), kernels.fused_mat_pool_plain(
                      spec, mats, part.masks)), 3, sync, batch=1),
                  "f1_whole_row": measured(lambda: kernels.fused_tree_cuda(*args),
                                           "fused_tree_kernel", sync)}
    log(f"residency: K5P and F1P against their live bytes, beside K5's and F1's whole-row "
        f"walks: {json.dumps(out)}")
    return out


def pool_aggregates(eng, seg, S, want_top, want_sum, want_min, want_group):
    """K3P and K6P on the residency phase's TopN(rt, Row(wf1=2), n=3) and
    Sum(seg, field=rv), through their wrappers with the engine's own
    arguments (its lowering, candidates, gates and plane rows): each result
    against numpy and both plain versions, exactly; then each kernel's
    times (``measured``) against the bytes it must read, the src or
    filter's leaves and the candidate rows or planes at the live blocks
    (``live_leaf_bytes`` and the rows on top), beside the whole-row walk
    (K3, K6) over the same rows, and the pool plain version's p50.  Then
    both again over a full live word, the src or filter OR'd with a dense
    row of rt, where the two walks read the same bytes.  Returns
    {"k3p": ..., "k6p": ..., "k3p_full": ..., "k6p_full": ...} and
    pool_minmax_group's items."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel import bsi, kernels
    from pilosa_tpu_torch.parallel.engine import _Lowering, decode_topn_full

    sync = torch.cuda.synchronize
    canonical = eng.canonical_shards("rsw")
    mask = eng._mask_words(list(range(S)), canonical)
    n_req = int((mask != 0).sum())
    rt = eng._stacks[("rsw", "rt", "standard")]
    entry = eng._topn_candidates("rsw", "rt", rt)
    n_out = min(3, entry.host_cnt.shape[1])
    vst = eng._stacks[("rsw", "rv", "bsig_rv")]
    depth = eng._bsi_group("rsw", "rv").bit_depth()
    planes = eng._plane_spec(vst, depth)
    n_planes = sum(1 for p in planes if p >= 0)
    out = {}
    for tag, src_q, filt_q in (("", "Row(wf1=2)", seg),
                               ("_full", "Union(Row(wf1=2), Row(rt=0))", f"Union({seg}, Row(rt=1))")):
        prog, lw = eng._lower_src("rsw", pql.parse(src_q).calls[0], canonical)
        code = kernels.compile_prog(prog)
        args = (lw.mats, mask, rt.matrix, entry.cand_idx)
        full = dict(scores=False, cnt=entry.dev_cnt, thr=1, n_out=n_out)
        got = kernels.score_rows_pool_cuda(code, *args, **full)[2]
        for plain in (kernels.topn_full_tree_pool_plain, kernels.topn_full_tree_plain):
            want = torch.stack(plain(prog, *args, entry.dev_cnt, 1, n_out))
            _exact("score_rows_pool", got.reshape(-1), want.reshape(-1),
                   f"residency TopN({src_q}) against {plain.__name__}")
        host = got.cpu().numpy()
        pairs = decode_topn_full((host[0], host[1]), entry.cands, n_out)
        if not tag and pairs != want_top:
            raise AssertionError(f"residency: K3P TopN {pairs} != numpy {want_top}")
        n_live = int(kernels.live_blocks(prog, lw.mats, mask.device).sum())
        byts = live_leaf_bytes(prog, lw.mats, mask) + len(entry.cands) * n_live * n_req * 2048
        bound = byts / HBM_BYTES_PER_S * 1e3
        for _ in range(3):
            kernels.score_rows_pool_cuda(code, *args, **full)
        sync()
        t_p = measured(lambda: kernels.score_rows_pool_cuda(code, *args, **full),
                       "score_rows_pool_kernel", sync, bound_ms=bound)
        t_w = measured(lambda: kernels.score_rows_cuda(code, *args, **full),
                       "score_rows_kernel", sync, bound_ms=bound)
        plain_ms = p50_ms(lambda: kernels.topn_full_tree_pool_plain(
            prog, *args, entry.dev_cnt, 1, n_out), 3, sync, batch=1)
        out["k3p" + tag] = {**t_p, "bound_ms": bound, "bytes": byts, "live_blocks": n_live,
                            "plain_ms": plain_ms, "k3_whole_row": t_w}
        lw = _Lowering(eng, canonical)
        fprog = eng._lower("rsw", pql.parse(filt_q).calls[0], lw)
        fcode = kernels.compile_prog(fprog)
        fargs = (lw.mats, mask, vst.matrix, planes)
        got = bsi.sum_tree_pool_cuda(fcode, *fargs)
        for plain in (bsi.sum_tree_pool_plain, bsi.sum_tree_plain):
            _exact("sum_tree_pool", got, plain(fprog, *fargs),
                   f"residency Sum({filt_q}) against {plain.__name__}")
        total = bsi.decode_sum(got.cpu().numpy(), depth, eng._bsi_group("rsw", "rv").min)
        if not tag and total != want_sum:
            raise AssertionError(f"residency: K6P Sum {total} != numpy {want_sum}")
        n_live = int(kernels.live_blocks(fprog, lw.mats, mask.device).sum())
        byts = live_leaf_bytes(fprog, lw.mats, mask) + n_planes * n_live * n_req * 2048
        bound = byts / HBM_BYTES_PER_S * 1e3
        for _ in range(3):
            bsi.sum_tree_pool_cuda(fcode, *fargs)
        sync()
        t_p = measured(lambda: bsi.sum_tree_pool_cuda(fcode, *fargs), "sum_tree_pool_kernel",
                       sync, bound_ms=bound)
        t_w = measured(lambda: bsi.sum_tree_cuda(fcode, *fargs), "sum_tree_kernel", sync,
                       bound_ms=bound)
        plain_ms = p50_ms(lambda: bsi.sum_tree_pool_plain(fprog, *fargs), 3, sync, batch=1)
        out["k6p" + tag] = {**t_p, "bound_ms": bound, "bytes": byts, "live_blocks": n_live,
                            "plain_ms": plain_ms, "k6_whole_row": t_w}
    log(f"residency: K3P and K6P against their live bytes, beside the whole-row walk: "
        f"{json.dumps(out)}")
    out.update(pool_minmax_group(eng, seg, S, want_min, want_group))
    return out


def pool_minmax_group(eng, seg, S, want_min, want_group):
    """K7P and K8P on the residency phase's Min(seg, field=rv), Max and
    GroupBy(Rows(field=rt), filter=seg), through their wrappers with the
    engine's own arguments (its lowering of seg, gates, plane rows and
    rt's rows): each result against numpy and both plain versions,
    exactly; then K7P's Min and K8P's register form timed (``measured``)
    against the bytes they must read, the filter's leaves and the planes
    (minmax_live_bytes) or listed rows at the live blocks, beside K7's and
    K8's whole-row walks over the same arguments (device ms), and the pool
    plain version's p50.  K7P's Max, device ms.  K8P's walk on the group fields [rt, rt]
    (4 x 4 combinations of rt's 4 rows, each row an input read once by the
    bound).  Then K7P and both K8P forms again over a full live word (seg
    OR'd with a dense row of rt, where each pool walk and its whole-row
    walk read the same bytes).  Returns {"k7p", "k8p", "k8p_walk", and
    each with "_full"}."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel import bsi, groupby, kernels
    from pilosa_tpu_torch.parallel.engine import _Lowering

    sync = torch.cuda.synchronize
    canonical = eng.canonical_shards("rsw")
    mask = eng._mask_words(list(range(S)), canonical)
    n_req = int((mask != 0).sum())
    rt = eng._stacks[("rsw", "rt", "standard")]
    rows = [rt.row_index[r] for r in range(4)]
    vst = eng._stacks[("rsw", "rv", "bsig_rv")]
    bsig = eng._bsi_group("rsw", "rv")
    planes = eng._plane_spec(vst, bsig.bit_depth())
    out = {}
    for tag, filt_q in (("", seg), ("_full", f"Union({seg}, Row(rt=1))")):
        lw = _Lowering(eng, canonical)
        fprog = eng._lower("rsw", pql.parse(filt_q).calls[0], lw)
        fcode = kernels.compile_prog(fprog)
        n_live = int(kernels.live_blocks(fprog, lw.mats, mask.device).sum())
        leaf_bytes = live_leaf_bytes(fprog, lw.mats, mask)
        fargs = (lw.mats, mask, vst.matrix, planes)
        for is_min in (True, False):
            got = bsi.minmax_tree_pool_cuda(fcode, *fargs, is_min)
            for plain in (bsi.minmax_tree_pool_plain, bsi.minmax_tree_plain):
                want = plain(fprog, *fargs, is_min)
                for g, w, what in zip(got, want, ("values", "counts")):
                    _exact("minmax_tree_pool", g, w,
                           f"residency {'Min' if is_min else 'Max'}({filt_q}) {what} against "
                           f"{plain.__name__}")
            if not tag and is_min:
                host = torch.stack(got).cpu().numpy()
                pair = bsi.decode_min_max(host, canonical, bsig.min, True)
                if pair != tuple(want_min):
                    raise AssertionError(f"residency: K7P Min {pair} != numpy {want_min}")
        byts = minmax_live_bytes(fprog, lw.mats, mask, vst.matrix, planes, leaf_bytes)
        bound = byts / HBM_BYTES_PER_S * 1e3
        k7p = lambda is_min=True: bsi.minmax_tree_pool_cuda(fcode, *fargs, is_min)  # noqa: E731
        for _ in range(3):
            k7p()
        sync()
        t_p = (measured(k7p, "minmax_tree_pool_kernel", sync, bound_ms=bound) if not tag else
               {"device_ms": device_ms(k7p, "minmax_tree_pool_kernel", bound_ms=bound)})
        out["k7p" + tag] = {
            **t_p, "bound_ms": bound, "bytes": byts, "live_blocks": n_live,
            "max_device_ms": device_ms(lambda: k7p(False), "minmax_tree_pool_kernel",
                                       bound_ms=bound),
            "plain_ms": p50_ms(lambda: bsi.minmax_tree_pool_plain(fprog, *fargs, True), 3, sync,
                               batch=1),
            "k7_whole_row_device_ms": device_ms(
                lambda: bsi.minmax_tree_cuda(fcode, *fargs, True), "minmax_tree_kernel",
                bound_ms=bound)}
        log(f"residency: K7P{tag} against its live bytes: {json.dumps(out['k7p' + tag])}")
        for form, fields in (("", [rt.matrix]), ("_walk", [rt.matrix, rt.matrix])):
            lists = [rows] * len(fields)
            gargs = (lw.mats, mask, fields, lists)
            assert groupby.groupn_plan([4] * len(fields))[0] == ("walk" if form else "registers")
            got = groupby.groupn_tree_pool_cuda(fcode, *gargs)
            for plain in (groupby.groupn_tree_pool_plain, groupby.groupn_tree_plain):
                _exact("groupn_tree_pool", got, plain(fprog, *gargs),
                       f"residency GroupBy {form or 'registers'} filter={filt_q} against "
                       f"{plain.__name__}")
            if not tag and not form:
                pairs = [(r, int(n)) for r, n in enumerate(got.cpu().tolist()) if n > 0]
                if pairs != want_group:
                    raise AssertionError(f"residency: K8P GroupBy {pairs} != numpy {want_group}")
            # Each input row read once: the walk's two levels list rt's
            # same 4 rows, and the full filter's Row(rt=1) is one of them.
            shared = sum(1 for leaf in fcode.leaves if len(leaf) == 2 and leaf[1] in rows
                         and lw.mats[leaf[0]].data_ptr() == rt.matrix.data_ptr())
            byts = leaf_bytes + (4 - shared) * n_live * n_req * 2048
            bound = byts / HBM_BYTES_PER_S * 1e3
            k8p = lambda gargs=gargs: groupby.groupn_tree_pool_cuda(fcode, *gargs)  # noqa: E731
            for _ in range(3):
                k8p()
            sync()
            t_p = (measured(k8p, "groupn_tree_pool_kernel", sync, bound_ms=bound)
                   if not tag and not form else
                   {"device_ms": device_ms(k8p, "groupn_tree_pool_kernel", bound_ms=bound)})
            out["k8p" + form + tag] = {
                **t_p, "bound_ms": bound, "bytes": byts, "live_blocks": n_live,
                "plain_ms": p50_ms(lambda gargs=gargs: groupby.groupn_tree_pool_plain(
                    fprog, *gargs), 3, sync, batch=1),
                "k8_whole_row_device_ms": device_ms(
                    lambda gargs=gargs: groupby.groupn_tree_cuda(fcode, *gargs),
                    "groupn_tree_kernel", bound_ms=bound)}
            log(f"residency: K8P{form}{tag} against its live bytes: "
                f"{json.dumps(out['k8p' + form + tag])}")
    return out


def rsw_queries(words, vcols, vvals):
    """The residency phase's 8-Count query and fused drain over build_rsw's
    index, with their numpy answers: (q8, want8, seg, entries,
    want_drain, lone).  The drain: two Counts sharing the pool-row subtree
    seg, a Sum of rv over seg, a TopN of rt's 4 rows against Row(wf1=2), a
    Min of rv over seg and a GroupBy of rt's 4 rows filtered by seg.
    ``lone``: {query: its numpy answer} of the Min, Max and GroupBy over
    seg through Executor.execute, in _pql_result's form."""
    from pilosa_tpu_torch import pql

    nw = RSW_BLOCKS * 256
    S = words["wf0"].shape[1]
    all_shards = list(range(S))
    eight = [(f"Count({op}(Row(wf{fi}={2 * fi}), Row(wf{fi}={2 * fi + 1})))", fi, op)
             for fi in range(RSW_FIELDS) for op in ("Intersect", "Union")]
    q8 = "".join(q for q, _, _ in eight)
    want8 = []
    for _, fi, op in eight:
        w = words[f"wf{fi}"]
        a, b = w[2 * fi][:, :nw], w[2 * fi + 1][:, :nw]
        want8.append(int(popcounts(a & b if op == "Intersect" else a | b).sum()))
    seg = "Intersect(Row(wf0=0), Row(wf0=1))"
    w0, w1, rt = words["wf0"], words["wf1"], words["rt"]
    segw = w0[0][:, :nw] & w0[1][:, :nw]
    in_seg = ((segw[vcols >> 20, (vcols & 0xFFFFF) >> 6] >> (vcols & 63).astype(np.uint64))
              & np.uint64(1)).astype(bool)
    want_sum = (int(vvals[in_seg].sum()), int(in_seg.sum()))
    seg_shard, seg_vals = vcols[in_seg] >> 20, vvals[in_seg]

    def extreme(is_min):
        """ValCount's reduce over the shards in canonical order: the first
        shard holding the extreme gives it with its own count; (0, 0) with
        no column considered."""
        best = (0, 0)
        for sh in np.unique(seg_shard):
            v = seg_vals[seg_shard == sh]
            x = int(v.min() if is_min else v.max())
            if best[1] == 0 or (x < best[0] if is_min else x > best[0]):
                best = (x, int((v == x).sum()))
        return best

    want_min, want_max = extreme(True), extreme(False)
    per_row = [int(popcounts(rt[r][:, :nw] & segw).sum()) for r in range(4)]
    totals = [(r, int(popcounts(rt[r][:, :nw] & w1[2][:, :nw]).sum())) for r in range(4)]
    want_top = sorted([p for p in totals if p[1] > 0], key=lambda p: (-p[1], -p[0]))[:3]
    entries = [
        ({"kind": "count", "call": pql.parse(seg).calls[0]}, all_shards),
        ({"kind": "count", "call": pql.parse(f"Union({seg}, Row(wf1=2))").calls[0]}, all_shards),
        ({"kind": "sum", "field": "rv", "filter": pql.parse(seg).calls[0]}, all_shards),
        ({"kind": "topnf", "field": "rt", "src": pql.parse("Row(wf1=2)").calls[0], "n": 3,
          "threshold": 1, "row_ids": None}, all_shards),
        ({"kind": "min", "field": "rv", "filter": pql.parse(seg).calls[0]}, all_shards),
        ({"kind": "group", "fields": ["rt"], "rows": [[0, 1, 2, 3]],
          "filter": pql.parse(seg).calls[0]}, all_shards),
    ]
    want_drain = [int(popcounts(segw).sum()),
                  int(popcounts(segw | w1[2][:, :nw]).sum()), want_sum, want_top, want_min,
                  per_row]
    lone = {f"Min({seg}, field=rv)": want_min, f"Max({seg}, field=rv)": want_max,
            f"GroupBy(Rows(field=rt), filter={seg})": [(r, n) for r, n in enumerate(per_row)
                                                       if n > 0]}
    return q8, want8, seg, entries, want_drain, lone


def drain_plain(got):
    """A fused_many result in rsw_queries' want_drain form: lists and
    numpy arrays (a GroupBy's counts) as lists, pairs as tuples."""
    return [g.tolist() if isinstance(g, np.ndarray) else list(g) if isinstance(g, list) else
            tuple(g) if isinstance(g, tuple) else g for g in got]


def run_residency_path(device, seed, n_shards=N_SHARDS, keep=None):
    """Tiered residency on the card (docs/residency.md; bench.py
    --residency-sweep at 960 shards): the index is 4x the device budget, so
    no field stack fits it.  Checks, each against numpy: a cold dashboard
    (one Count(Intersect) per field) answered exactly from the host lane,
    host fallbacks and promotion requests rising; after the promotions the
    same dashboard from the block pools (K1P, no fallback);
    an 8-Count query on pool rows (one K5P), a fused drain of Counts, a Sum,
    a TopN, a Min and a GroupBy whose filters read pool rows (F1P, then
    K6P, K3P, K7P and K8P over its slots); TopN, Sum, Min, Max and GroupBy
    through the executor (K3P, K6P, K7P, K8P); an uncovered row
    growing the working set; Sets into empty blocks, a Clear and an import,
    synced in place into the pool with a freed slot reused; working sets
    rotated until the budget evicts and a cached fused plan is dropped.
    Prints bench.py's numbers, K1P's time against its bound beside K1's
    over the same pool rows, and the device time of K5P, F1P, K3P, K6P,
    K7P, K8P and the whole drain.  Runs on its own holder and engines, freed
    at the end.  Returns the phase's numbers, its launches over pools, the
    rowb entry's K1 times, K1P's launches and times, and K3P's, K6P's,
    K7P's, K8P's, K5P's and F1P's launches and times.  With ``keep`` (a
    dict) the holder stays open for the observe phase, which reuses it:
    ``keep`` gets the holder and the fields' words."""
    import gc

    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.parallel import bsi, groupby, kernels
    from pilosa_tpu_torch.parallel.engine import TorchEngine, _Lowering

    t_phase = time.perf_counter()
    card = device.type == "cuda"  # a CPU rehearsal has no times or launches
    out = {"card": card_line(), "shards": n_shards}
    t0 = time.perf_counter()
    holder = Holder(device=device)
    holder.open()
    words, (vcols, vvals) = build_rsw(holder, n_shards)
    out["made_s"] = time.perf_counter() - t0
    S = n_shards
    all_shards = list(range(S))
    stack_bytes = RSW_ROWS * S * ROW_SHARD_BYTES
    total = RSW_FIELDS * stack_bytes
    budget = total // 4 - S * ROW_SHARD_BYTES
    assert stack_bytes > budget, "shape error: a full stack must not fit the budget"
    out.update(index_bytes=total, budget_bytes=budget, stack_bytes=stack_bytes)
    log(f"residency: index rsw {total / 1e9:.3f} GB over {RSW_FIELDS} stacks of "
        f"{stack_bytes / 1e9:.3f} GB, budget {budget / 1e9:.3f} GB (4x oversubscribed); "
        f"made in {out['made_s']:.3f} s")
    nw = RSW_BLOCKS * 256

    def pc_and(a, b):
        return int(and_popcounts(a[:, :nw], b[:, :nw]).sum())

    dashboard = []
    for fi in range(RSW_FIELDS):
        w = words[f"wf{fi}"]
        q = f"Count(Intersect(Row(wf{fi}={2 * fi}), Row(wf{fi}={2 * fi + 1})))"
        dashboard.append((q, pc_and(w[2 * fi], w[2 * fi + 1])))

    def run_dash(ex, dash):
        for q, want in dash:
            got = ex.execute("rsw", q).results[0]
            if got != want:
                raise AssertionError(f"residency: {q} = {got}, numpy {want}")

    def dash_p50(ex, reps):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            run_dash(ex, dashboard)
            times.append((time.perf_counter() - t) / len(dashboard) * 1e3)
        return statistics.median(times)

    # The engine's default budget, from the card's memory.
    free, total_mem = torch.cuda.mem_get_info() if card else (1 << 62, 0)
    out["engine_default_budget"] = TorchEngine(Holder(device=device), device=device).max_resident_bytes
    out["card_memory_bytes"] = total_mem
    # Fully resident: budget twice the index; its stacks take 16 GB.
    if free < total + (4 << 30):
        raise AssertionError(f"residency: {free / 1e9:.1f} GB free on the card, the fully "
                             f"resident engine needs {total / 1e9:.1f} GB and headroom")
    eng_full = TorchEngine(holder, device=device, max_resident_bytes=2 * total)
    eng_full.result_memo.maxsize = 0
    ex_full = Executor(holder, engine=eng_full)
    run_dash(ex_full, dashboard)
    assert eng_full.host_fallbacks == 0 and eng_full.stack_rebuilds == RSW_FIELDS
    out["fully_resident_count_p50_ms"] = dash_p50(ex_full, 8)
    # The dense K1 over the first dashboard query's two rows, for the pool
    # leaf's comparison below.
    call = pql.parse(dashboard[0][0][6:-1]).calls[0]
    lw_d = _Lowering(eng_full, eng_full.canonical_shards("rsw"))
    prog_d = eng_full._lower("rsw", call, lw_d)
    mask_all = eng_full._mask_words(all_shards, lw_d.canonical)
    code_d = kernels.compile_prog(prog_d)
    sync = torch.cuda.synchronize
    if card:
        out["dense_k1_device_ms"] = measured(
            lambda: kernels.count_tree_dense(code_d, lw_d.mats, mask_all),
            "count_tree_dense", sync)["device_ms"]
    del lw_d, prog_d, code_d
    eng_full.close()
    del eng_full, ex_full
    gc.collect()
    if card:
        torch.cuda.empty_cache()

    # -- 4x oversubscribed ------------------------------------------------
    eng = TorchEngine(holder, device=device, max_resident_bytes=budget)
    eng.result_memo.maxsize = 0
    ex = Executor(holder, engine=eng)
    zero_counts(POOL_KERNELS + COUNT_KERNELS)
    kernels.pool_leaf.by_kernel.clear()
    # 1. Cold: the host lane answers, each stack misses and requests a
    # promotion of the query's rows.
    t = time.perf_counter()
    run_dash(ex, dashboard)
    out["oversubscribed_4x_cold_p50_ms"] = (time.perf_counter() - t) / len(dashboard) * 1e3
    snap = eng.residency.snapshot()
    if eng.host_fallbacks < RSW_FIELDS or snap["requests"] < RSW_FIELDS:
        raise AssertionError(f"residency: cold dashboard {eng.host_fallbacks} fallbacks, "
                             f"{snap['requests']} requests; expected {RSW_FIELDS} each")
    out["cold"] = {"host_fallbacks": eng.host_fallbacks, "requests": snap["requests"],
                   "count_tree_dense": kernels.count_tree_dense.launches}
    t = time.perf_counter()
    assert eng.residency.flush(300.0), "residency: the promotions did not drain"
    out["promote_s"] = time.perf_counter() - t
    snap = eng.residency.snapshot()
    if snap["partialPromotions"] < RSW_FIELDS:
        raise AssertionError(f"residency: {snap['partialPromotions']} partial promotions")
    for fi in range(RSW_FIELDS):
        st = eng._stacks[("rsw", f"wf{fi}", "standard")]
        assert st.pool and set(st.row_index) == {2 * fi, 2 * fi + 1}, (fi, st.row_index)
        assert not np.any(st.occ & ~st.block_mask)
    out["pool_shape"] = list(eng._stacks[("rsw", "wf0", "standard")].matrix.shape)
    # 2. Warm: the same dashboard from the pools, no fallback, one K1P
    # launch over pool leaves per query.
    fb0, k1p = eng.host_fallbacks, kernels.pool_leaf.by_kernel.get("count_tree_pool", 0)
    out["oversubscribed_4x_count_p50_ms"] = dash_p50(ex, RSW_WARM_REPS)
    n_warm = RSW_WARM_REPS * len(dashboard)
    fallbacks = eng.host_fallbacks - fb0
    out["residency_hit_rate"] = (n_warm - fallbacks) / n_warm
    pool_k1p = kernels.pool_leaf.by_kernel.get("count_tree_pool", 0) - k1p
    if fallbacks or (card and pool_k1p < n_warm):
        raise AssertionError(f"residency: warm dashboard {fallbacks} fallbacks, "
                             f"{pool_k1p} K1P launches over pool leaves of {n_warm} queries")
    out["warm"] = {"queries": n_warm, "host_fallbacks": fallbacks, "k1p_pool_launches": pool_k1p}
    out["within_2x"] = out["oversubscribed_4x_count_p50_ms"] <= 2 * out["fully_resident_count_p50_ms"]
    # K1P over each query's two pool rows against the bytes of their live
    # blocks, and the K1 it replaced (which visits every position) over the
    # same rows.  The timing windows take the four queries in turn, as the
    # dashboard does: 4 x 31.5 MB, more than the card's 50 MB L2.  Their
    # checks and timing launches are not the path's (_path_counts_kept).
    with _path_counts_kept():
        lw = _Lowering(eng, eng.canonical_shards("rsw"))
        progs = [eng._lower("rsw", pql.parse(q[6:-1]).calls[0], lw) for q, _ in dashboard]
        codes = [kernels.compile_prog(p) for p in progs]
        for prog, code, (_, want) in zip(progs, codes, dashboard):
            assert prog[1][0] == "rowb" and prog[2][0] == "rowb", prog
            for fn in (kernels.count_tree, kernels.count_tree_pool_plain,
                       kernels.count_tree_plain):
                got = int(fn(prog, lw.mats, mask_all))
                if got != want:
                    raise AssertionError(f"residency: {fn.__name__} {got} != numpy {want}")
            if card and int(kernels.count_tree_dense(code, lw.mats, mask_all)) != want:
                raise AssertionError("residency: K1 over the pool rows disagrees with numpy")
        pool_bytes = live_leaf_bytes(progs[0], lw.mats, mask_all)
        assert all(live_leaf_bytes(p, lw.mats, mask_all) == pool_bytes for p in progs)
        bound = pool_bytes / HBM_BYTES_PER_S * 1e3
        none = {"ms": None, "device_ms": None, "host_us": None}
        t_k1p, t_k1, plain_k1p, plain_k1 = none, none, None, None
        it = iter(range(10 ** 9))
        if card:
            t_k1p = measured(lambda: kernels.count_tree_pool(codes[next(it) % 4], lw.mats,
                                                             mask_all),
                             "count_tree_pool", sync, bound_ms=bound)
            t_k1 = measured(lambda: kernels.count_tree_dense(codes[next(it) % 4], lw.mats,
                                                             mask_all),
                            "count_tree_dense", sync, bound_ms=bound)
            plain_k1p = p50_ms(lambda: kernels.count_tree_pool_plain(progs[0], lw.mats,
                                                                     mask_all), 3, sync, batch=1)
            plain_k1 = p50_ms(lambda: kernels.count_tree_plain(progs[0], lw.mats, mask_all), 3,
                              sync, batch=1)
        out["rowb_k1p"] = {**t_k1p, "bound_ms": bound, "bytes": pool_bytes, "plain_ms": plain_k1p,
                           "k1_device_ms": t_k1["device_ms"],
                           "dense_k1_device_ms": out.get("dense_k1_device_ms")}
        rowb_times = (t_k1, plain_k1, pool_bytes)
        k1p_times = (t_k1p, plain_k1p, pool_bytes)
        del lw, progs, codes
    # 3a. Eight Counts on pool rows: one K5P launch.
    q8, want8, seg, entries, want_drain, lone = rsw_queries(words, vcols, vvals)
    want_sum, want_top = want_drain[2], want_drain[3]
    w0 = words["wf0"]
    k5, k5p, pk5 = (kernels.count_batch_tree_cuda.launches,
                    kernels.count_batch_tree_pool_cuda.launches,
                    kernels.pool_leaf.by_kernel.get("count_batch_tree", 0))
    got8 = ex.execute("rsw", q8).results
    if got8 != want8:
        raise AssertionError(f"residency: 8 Counts {got8} != numpy {want8}")
    if card and (kernels.count_batch_tree_pool_cuda.launches - k5p != 1
                 or kernels.count_batch_tree_cuda.launches != k5
                 or kernels.pool_leaf.by_kernel.get("count_batch_tree", 0) - pk5 != 1):
        raise AssertionError("residency: the 8-Count query was not one K5P launch over pools")
    # 3b. A fused drain: Counts sharing a pool-row subtree, a Sum, a TopN, a
    # Min and a GroupBy filtered by pool rows (rv and rt are small full
    # stacks that fit).
    eng.fused_many("rsw", entries)  # first: rv and rt are built (they fit)
    # Each warm drain: one F1P launch, then its Sum edge on K6P, its TopN
    # edge on K3P, its Min edge on K7P and its group edge on K8P (the slots
    # read as pool rows), no F1 and no whole-row walk; the pool leaf's
    # counts show the edges under their kernels' names.
    drain_fns = (kernels.fused_tree_pool_cuda, kernels.fused_tree_cuda,
                 bsi.sum_tree_pool_cuda, bsi.sum_tree_cuda, kernels.score_rows_pool_cuda,
                 kernels.score_rows_cuda, bsi.minmax_tree_pool_cuda, bsi.minmax_tree_cuda,
                 groupby.groupn_tree_pool_cuda, groupby.groupn_tree_cuda)
    by_kernel = ("fused_tree", "sum_tree", "score_rows", "minmax_tree", "groupn_tree")
    n_drains = 3
    before = ([f.launches for f in drain_fns],
              [kernels.pool_leaf.by_kernel.get(k, 0) for k in by_kernel])
    for _ in range(n_drains):
        got = eng.fused_many("rsw", entries)
        if drain_plain(got) != want_drain:
            raise AssertionError(f"residency: fused drain {got} != numpy {want_drain}")
    per_drain = {f.__name__: (f.launches - n0) / n_drains for f, n0 in zip(drain_fns, before[0])}
    pool_edges = {k: (kernels.pool_leaf.by_kernel.get(k, 0) - n0) / n_drains
                  for k, n0 in zip(by_kernel, before[1])}
    out["drain_launches"] = {"per_drain": per_drain, "pool_leaf_by_kernel": pool_edges}
    if card and (per_drain != {"fused_tree_pool_cuda": 1, "fused_tree_cuda": 0,
                               "sum_tree_pool_cuda": 1, "sum_tree_cuda": 0,
                               "score_rows_pool_cuda": 1, "score_rows_cuda": 0,
                               "minmax_tree_pool_cuda": 1, "minmax_tree_cuda": 0,
                               "groupn_tree_pool_cuda": 1, "groupn_tree_cuda": 0}
                 or pool_edges != {k: 1 for k in by_kernel}):
        raise AssertionError(f"residency: a warm drain was not one F1P launch with one K6P, "
                             f"one K3P, one K7P and one K8P edge: {out['drain_launches']}")
    plans = len(eng._fused_plans)
    assert plans >= 1, "residency: the fused drain's plan was not cached"
    # 3c. TopN and Sum through the executor: K3P and K6P over a pool row
    # (the pool leaf's count keeps their launches under K3's and K6's names).
    k3, k6 = (kernels.pool_leaf.by_kernel.get("score_rows", 0),
              kernels.pool_leaf.by_kernel.get("sum_tree", 0))
    k3p, k6p = kernels.score_rows_pool_cuda.launches, bsi.sum_tree_pool_cuda.launches
    q_top, q_sum = "TopN(rt, Row(wf1=2), n=3)", f"Sum({seg}, field=rv)"

    def run_top():
        got = ex.execute("rsw", q_top).results[0]
        got = [(p.id, p.count) if hasattr(p, "id") else tuple(p) for p in got]
        if got != want_top:
            raise AssertionError(f"residency: TopN {got} != numpy {want_top}")

    def run_sum():
        vc = ex.execute("rsw", q_sum).results[0]
        if (vc.val, vc.count) != want_sum:
            raise AssertionError(f"residency: Sum {(vc.val, vc.count)} != numpy {want_sum}")

    run_top()
    run_sum()
    if card and (kernels.pool_leaf.by_kernel.get("score_rows", 0) == k3
                 or kernels.pool_leaf.by_kernel.get("sum_tree", 0) == k6
                 or kernels.score_rows_pool_cuda.launches == k3p
                 or bsi.sum_tree_pool_cuda.launches == k6p):
        raise AssertionError("residency: TopN/Sum did not launch K3P/K6P over a pool row")
    # 3d. Min, Max and GroupBy over seg through the executor: one K7P or K8P
    # launch each over a pool row, no whole-row K7 or K8.
    lone_fns = (bsi.minmax_tree_pool_cuda, bsi.minmax_tree_cuda, groupby.groupn_tree_pool_cuda,
                groupby.groupn_tree_cuda)

    def run_lone(q):
        got = _pql_result(ex.execute("rsw", q).results[0])
        if got != lone[q]:
            raise AssertionError(f"residency: {q} {got} != numpy {lone[q]}")

    for q in lone:
        before = [f.launches for f in lone_fns]
        run_lone(q)
        step = [f.launches - n0 for f, n0 in zip(lone_fns, before)]
        if card and step != ([0, 0, 1, 0] if q.startswith("GroupBy") else [1, 0, 0, 0]):
            raise AssertionError(f"residency: {q} launched (K7P, K7, K8P, K8) {step}, not one "
                                 "K7P or K8P")
    def run_drain():
        got = eng.fused_many("rsw", entries)
        if drain_plain(got) != want_drain:
            raise AssertionError(f"residency: fused drain {got} != numpy {want_drain}")

    def run_eight():
        if ex.execute("rsw", q8).results != want8:
            raise AssertionError("residency: the 8 Counts disagree with numpy")

    # Their end-to-end p50s through Executor.execute (the drain's through
    # fused_many; memo off).
    q_min, _, q_group = lone
    for name, fn in (("pool_topn_e2e_p50_ms", run_top), ("pool_sum_e2e_p50_ms", run_sum),
                     ("pool_min_e2e_p50_ms", lambda: run_lone(q_min)),
                     ("pool_groupby_e2e_p50_ms", lambda: run_lone(q_group)),
                     ("pool_drain_e2e_p50_ms", run_drain),
                     ("pool_eight_counts_e2e_p50_ms", run_eight)):
        times = []
        for _ in range(RSW_WARM_REPS):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(times)
    # 3e. The pool leaf inside K3P and K6P on the calls of 3c and every
    # kernel of one drain: device ms against the bytes of the live blocks.
    if card:
        with _path_counts_kept():
            out["pool_leaf_in"] = pool_leaf_in(eng, ex, holder, entries, seg, S)
            out["pool_aggregates"] = pool_aggregates(eng, seg, S, want_top, want_sum,
                                                     lone[q_min], lone[q_group])
            out["pool_batch_and_drain"] = pool_batch_and_drain(eng, q8, entries, S)
    # 4. An uncovered row grows the working set and keeps the old rows.
    qg = "Count(Intersect(Row(wf0=30), Row(wf0=31)))"
    wantg = pc_and(w0[30], w0[31])
    fb = eng.host_fallbacks
    if ex.execute("rsw", qg).results[0] != wantg or eng.host_fallbacks != fb + 1:
        raise AssertionError("residency: the uncovered rows were not a counted miss")
    assert eng.residency.flush(300.0)
    st0 = eng._stacks[("rsw", "wf0", "standard")]
    assert {0, 1, 30, 31} <= set(st0.row_index), st0.row_index
    fb = eng.host_fallbacks
    run_dash(ex, [(qg, wantg), dashboard[0]])
    if eng.host_fallbacks != fb:
        raise AssertionError("residency: the grown working set missed")
    # 5. Writes into the pool, synced in place: Sets into empty blocks of
    # promoted rows (every never-written slot taken), a Clear that empties
    # a block (its slot freed), and an import whose new block takes the
    # freed slot (zeroed first) and whose other bit lands in an occupied
    # block (a word write).  Shard 0; each Set its own column.
    qu = "Count(Union(Row(wf0=0), Row(wf0=1)))"
    want_u = int(popcounts(w0[0][:, :nw] | w0[1][:, :nw]).sum())
    rebuilds, updates = eng.stack_rebuilds, eng.stack_updates
    st0 = eng._stacks[("rsw", "wf0", "standard")]
    virgin = int(st0.matrix.shape[0]) - st0.pool_next
    slots_free = [(r, b) for r in (0, 1) for b in range(RSW_BLOCKS, 64)]
    assert virgin < len(slots_free), (virgin, len(slots_free))
    taken = slots_free[:virgin]
    sets = "".join(f"Set({b * 16384 + 5 + r}, wf0={r})" for r, b in taken)
    got = ex.execute("rsw", sets + qu).results[-1]
    want_u += len(taken)
    if got != want_u or st0.pool_next != st0.matrix.shape[0] or st0.free_dirty:
        raise AssertionError(f"residency: Union after {len(taken)} Sets {got} != {want_u}, "
                             f"or the never-written slots were not all taken")
    r_c, b_c = taken[-1]
    freed = int(st0.slot_of[r_c][b_c])
    got = ex.execute("rsw", f"Clear({b_c * 16384 + 5 + r_c}, wf0={r_c})" + qu).results[-1]
    want_u -= 1
    if got != want_u or freed not in st0.free_dirty or int(st0.slot_of[r_c][b_c]) != 0:
        raise AssertionError(f"residency: the Clear did not free slot {freed} ({got}, {want_u})")
    r_n, b_n = slots_free[virgin]
    # The import's second bit: a column of occupied block 3 clear in both
    # rows and outside rv, so that only the Union moves (by one).
    cand = np.arange(3 * 16384, 4 * 16384, dtype=np.int64)
    clear = (_bit_of(w0, 0, cand) | _bit_of(w0, 1, cand)) == 0
    col_old = int(cand[clear & ~np.isin(cand, vcols)][0])
    col_new = b_n * 16384 + 9
    holder.index("rsw").field("wf0").import_bulk([r_n, r_n], [col_new, col_old])
    want_u += 2
    got = ex.execute("rsw", qu).results[0]
    if got != want_u:
        raise AssertionError(f"residency: Union after the import {got} != numpy {want_u}")
    if int(st0.slot_of[r_n][b_n]) != freed:
        raise AssertionError("residency: the freed slot was not reused")
    if eng.stack_rebuilds != rebuilds or eng.stack_updates < updates + 3:
        raise AssertionError(f"residency: writes rebuilt the pool ({eng.stack_rebuilds - rebuilds} "
                             f"rebuilds, {eng.stack_updates - updates} in-place syncs)")
    if int(st0.matrix[0].abs().sum()) != 0:
        raise AssertionError("residency: slot 0 is not zero")
    out["writes"] = {"sets": len(taken), "freed_slot": freed, "reused": True,
                     "stack_updates": eng.stack_updates - updates,
                     "stack_rebuilds": eng.stack_rebuilds - rebuilds}
    # 6. Rotate working sets in until the budget evicts; the cached fused
    # plan is dropped with its pool, and everything stays exact.
    ev0, bev0 = eng.evictions, eng.budget_evictions
    for off in RSW_ROTATIONS:
        rot = []
        for fi in range(RSW_FIELDS):
            w = words[f"wf{fi}"]
            ra, rb = off + 2 * fi, off + 2 * fi + 1
            rot.append((f"Count(Intersect(Row(wf{fi}={ra}), Row(wf{fi}={rb})))",
                        pc_and(w[ra], w[rb])))
        run_dash(ex, rot)
        assert eng.residency.flush(300.0), "residency: rotation promotions did not drain"
        run_dash(ex, rot)
    if eng.budget_evictions - bev0 < 1 or len(eng._fused_plans) >= plans:
        raise AssertionError(f"residency: rotation evicted {eng.budget_evictions - bev0} stacks "
                             f"for the budget, {len(eng._fused_plans)} fused plans cached")
    # The drain's working set went with the eviction: it misses (each item
    # fails alone with ResidencyMiss, for its caller's host lane), its rows
    # are promoted, and then it runs on the card again.
    from pilosa_tpu_torch.parallel.errors import ResidencyMiss

    misses = 0
    for _ in range(3):
        try:
            got = eng.fused_many("rsw", entries)
            break
        except ResidencyMiss:
            misses += 1
            assert eng.residency.flush(300.0)
    else:
        raise AssertionError("residency: the fused drain missed three times after the eviction")
    if drain_plain(got) != want_drain:
        raise AssertionError(f"residency: fused drain after eviction {got} != {want_drain}")
    out["drain_misses_after_eviction"] = misses
    run_dash(ex, dashboard)
    assert eng.residency.flush(300.0)
    snap = eng.residency.snapshot()
    out["rotation"] = {"evictions": eng.evictions - ev0,
                       "budget_evictions": eng.budget_evictions - bev0,
                       "resident_bytes": eng._resident_bytes,
                       "fused_plans_dropped": True}
    out["promotion_overlap_mbits_s"] = (snap["promotedBytes"] * 8 / max(snap["promoteSeconds"],
                                                                        1e-9) / 1e6)
    out["residency"] = snap
    out["cache"] = {k: v for k, v in eng.cache_snapshot().items()
                    if k not in ("workingSet", "residency")}
    out["pool_leaf_launches"] = dict(kernels.pool_leaf.by_kernel)
    launches = kernels.pool_leaf.launches
    k1p_launches = kernels.count_tree_pool.launches
    aggs = {"score_rows_pool": (kernels.score_rows_pool_cuda.launches, "pool_aggregates", "k3p"),
            "sum_tree_pool": (bsi.sum_tree_pool_cuda.launches, "pool_aggregates", "k6p"),
            "minmax_tree_pool": (bsi.minmax_tree_pool_cuda.launches, "pool_aggregates", "k7p"),
            "groupn_tree_pool": (groupby.groupn_tree_pool_cuda.launches, "pool_aggregates",
                                 "k8p"),
            "count_batch_tree_pool": (kernels.count_batch_tree_pool_cuda.launches,
                                      "pool_batch_and_drain", "k5p"),
            "fused_tree_pool": (kernels.fused_tree_pool_cuda.launches, "pool_batch_and_drain",
                                "f1p")}
    if card and not all(n for n, _, _ in aggs.values()):
        raise AssertionError(f"residency: K3P, K6P, K7P, K8P, K5P or F1P never launched: {aggs}")
    aggs = {k: (n, out[part][key] if card else None) for k, (n, part, key) in aggs.items()}
    for k in ("count_tree_pool", "count_batch_tree", "fused_tree", "score_rows", "sum_tree",
              "minmax_tree", "groupn_tree"):
        if card and not kernels.pool_leaf.by_kernel.get(k):
            raise AssertionError(f"residency: {k} never launched over a pool: "
                                 f"{kernels.pool_leaf.by_kernel}")
    eng.close()
    del eng, ex
    if keep is not None:
        keep.update(holder=holder, words=words)
    else:
        holder.close()
    del holder, words
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"residency: oversubscribed_4x_count_p50_ms {out['oversubscribed_4x_count_p50_ms']:.4f}, "
        f"fully_resident_count_p50_ms {out['fully_resident_count_p50_ms']:.4f} "
        f"(within 2x: {out['within_2x']}), oversubscribed_4x_cold_p50_ms "
        f"{out['oversubscribed_4x_cold_p50_ms']:.4f}, residency_hit_rate "
        f"{out['residency_hit_rate']:.4f}, promotion_overlap_mbits_s "
        f"{out['promotion_overlap_mbits_s']:.1f}; rowb K1P device {t_k1p['device_ms']} ms "
        f"(K1 {t_k1['device_ms']} ms), bound {bound:.4f} ms; pool_topn_e2e_p50_ms "
        f"{out['pool_topn_e2e_p50_ms']:.4f}, pool_sum_e2e_p50_ms "
        f"{out['pool_sum_e2e_p50_ms']:.4f}, pool_min_e2e_p50_ms "
        f"{out['pool_min_e2e_p50_ms']:.4f}, pool_groupby_e2e_p50_ms "
        f"{out['pool_groupby_e2e_p50_ms']:.4f}, pool_drain_e2e_p50_ms "
        f"{out['pool_drain_e2e_p50_ms']:.4f}, pool_eight_counts_e2e_p50_ms "
        f"{out['pool_eight_counts_e2e_p50_ms']:.4f}; engine_default_budget "
        f"{out['engine_default_budget']}; {out['card']}")
    return out, launches, rowb_times, (k1p_launches,) + k1p_times, aggs


# -- the observe phase: working-set heat, promote-ahead and the node's ---------
# self-observation (bench.py:2333-2392, 3225-3331, 3380-3460)

OBS_AB_CYCLES, OBS_AB_LEARN = 12, 2  # bench.py AB_CYCLES, AB_LEARN
ADV_SHARDS = 4  # bench.py ADV_SHARDS
ADV_WARM_PAIRS, ADV_SCORE_PAIRS = 12, 64  # bench.py ADV_WARM_PAIRS, ADV_SCORE_PAIRS
ADV_P50_REPS = 48  # bench.py ADV_P50_REPS
ADV_REPLAY_N, ADV_REPLAY_LOOPS = 4000, 8  # bench.py ADV_REPLAY_N, ADV_REPLAY_LOOPS
HIST_P50_REPS = 48  # bench.py HIST_P50_REPS
HIST_TICK_N, HIST_TICK_LOOPS = 240, 8  # bench.py HIST_TICK_N, HIST_TICK_LOOPS
HIST_SEED_TICKS, HIST_READ_REPS = 120, 32  # bench.py HIST_SEED_TICKS, HIST_READ_REPS
OBS_SLO_WINDOW_S = 6.0  # the node's [observability] slo-window


def _reset_observers():
    from pilosa_tpu_torch.parallel.advisor import ADVISOR
    from pilosa_tpu_torch.util import plan_miner
    from pilosa_tpu_torch.util.heat import HEAT

    HEAT.reset()
    plan_miner.MINER.reset()
    ADVISOR.reset()
    ADVISOR.drive_promotions = True


def _promotions_by_cause(journal):
    by = {}
    for e in journal.events(type="engine.promotion"):
        c = e.fields.get("cause")
        by[c] = by.get(c, 0) + 1
    return by


def _pool_tier(holder, index, field, rows):
    """The slots of the block pool the engine promotes for ``rows`` of a
    field's standard view: one slot per block occupied in any shard, times
    two, to a power of two (engine.py's ``P_cap``)."""
    frags = holder.index(index).field(field).view("standard").fragments.values()
    n = 0
    for r in rows:
        u = 0
        for f in frags:
            if f.row_count(r):
                u |= int(f.row_occupancy(r))
        n += u.bit_count()
    return 1 << max(3, (2 * n + 1).bit_length())


def advisor_ab(device, holder, words):
    """bench.py's promote-ahead A/B at equal budget (bench.py:2333-2392) on
    the residency phase's rsw index: two single-query dashboards over
    disjoint stacks (wf1 and wf3) alternate, with a residency flush as the
    gap, under a budget that holds one 64-slot pool of the 960 shards but
    not two.  Advisor off pays a host fallback and a demand promotion every
    swing; advisor on promotes the next stack during the gap, so a warm
    arrival runs K1P over its pool rows.  Every answer is checked against
    numpy; the learning cycles are left out of the p50."""
    from pilosa_tpu_torch.api import API, QueryRequest
    from pilosa_tpu_torch.parallel import kernels
    from pilosa_tpu_torch.parallel.advisor import ADVISOR
    from pilosa_tpu_torch.parallel.engine import TorchEngine
    from pilosa_tpu_torch.util.events import EventJournal

    card = device.type == "cuda"
    S = len(holder.index("rsw").field("wf0").view("standard").fragments)
    nw = RSW_BLOCKS * 256
    pool64_bytes = 64 * S * 512 * 4  # one 64-slot pool: 2 KiB a slot and shard
    budget = (3 * pool64_bytes) // 2
    reqs = []
    # bench.py alternates wf0 and wf2; the residency phase's write checks
    # grew rows 0 and 1 of wf0 past 8 occupied blocks in shard 0, so their
    # pool would take a 128-slot tier this budget cannot hold.  wf1 and wf3
    # are untouched and of the same shape.
    for fi in (1, 3):
        ra, rb = 2 * fi, 2 * fi + 1
        # The budget holds one 64-slot pool and not two: a stack whose pool
        # takes another tier would change what the A/B measures.
        tier = _pool_tier(holder, "rsw", f"wf{fi}", (ra, rb))
        if tier != 64:
            raise AssertionError(f"observe: A/B rows {ra}, {rb} of wf{fi} take a {tier}-slot "
                                 f"pool, not the 64-slot tier the budget is sized for")
        w = words[f"wf{fi}"]
        reqs.append((QueryRequest("rsw", f"Count(Intersect(Row(wf{fi}={ra}), Row(wf{fi}={rb})))"),
                     int(and_popcounts(w[ra][:, :nw], w[rb][:, :nw]).sum())))
    out = {"pool64_bytes": pool64_bytes, "budget_bytes": budget, "cycles": OBS_AB_CYCLES,
           "learn": OBS_AB_LEARN}

    def arm(drive):
        _reset_observers()
        ADVISOR.drive_promotions = drive
        journal = EventJournal()
        eng = TorchEngine(holder, device=device, max_resident_bytes=budget, journal=journal)
        eng.result_memo.maxsize = 0
        api = API(holder=holder, engine=eng)
        k1p0 = kernels.count_tree_pool.launches
        times = []
        try:
            for cyc in range(OBS_AB_CYCLES):
                for req, want in reqs:
                    t0 = time.perf_counter()
                    got = int(api.query(req).results[0])
                    dt = time.perf_counter() - t0
                    if got != want:
                        raise AssertionError(f"observe: A/B {req.query} = {got}, numpy {want}")
                    # The gap: the promotion the miss queued, or the one the
                    # advisor drove, lands inside it.
                    assert eng.residency.flush(120.0)
                    gc.collect()
                    if cyc >= OBS_AB_LEARN:
                        times.append(dt)
            doc = ADVISOR.to_doc()
            res = {"p50_ms": statistics.median(times) * 1e3,
                   "host_fallbacks": eng.host_fallbacks,
                   "promotions_by_cause": _promotions_by_cause(journal),
                   "k1p_launches": kernels.count_tree_pool.launches - k1p0,
                   "driven_requests": doc["drivenRequests"],
                   "hit_rate": doc["hitRate"],
                   "residency": eng.residency.snapshot(),
                   "last_promote_error": eng.last_promote_error}
        finally:
            ADVISOR.drive_promotions = True
            eng.close()
            del api, eng
            gc.collect()
        return res

    out["off"] = arm(False)
    out["on"] = arm(True)
    out["residency_advisor_ab_speedup"] = out["off"]["p50_ms"] / max(out["on"]["p50_ms"], 1e-9)
    on = out["on"]
    if on["promotions_by_cause"].get("advisor", 0) <= 0 or on["driven_requests"] <= 0:
        raise AssertionError(f"observe: the advisor-on arm drove no promotion: {on}")
    if out["off"]["promotions_by_cause"].get("advisor", 0):
        raise AssertionError(f"observe: the advisor-off arm promoted ahead: {out['off']}")
    if card and on["k1p_launches"] <= 0:
        raise AssertionError(f"observe: K1P never launched in the advisor-on arm: {on}")
    log(f"observe: residency_advisor_ab_speedup {out['residency_advisor_ab_speedup']:.4f} "
        f"(off p50 {out['off']['p50_ms']:.4f} ms, {out['off']['host_fallbacks']} host "
        f"fallbacks, promotions {out['off']['promotions_by_cause']}, K1P "
        f"{out['off']['k1p_launches']}; on p50 {out['on']['p50_ms']:.4f} ms, "
        f"{on['host_fallbacks']} host fallbacks, promotions {on['promotions_by_cause']}, K1P "
        f"{on['k1p_launches']}, driven {on['driven_requests']}) at a budget of "
        f"{budget / 1e6:.1f} MB over {S} shards")
    return out


def advisor_sweep(device, seed):
    """bench.py --advisor-sweep (bench.py:3225-3331) on the card: two
    Counts over disjoint rows (0/1 and 8/9 of index adv, 4 shards of random
    words) alternate through the API with the memo off; after the learning
    pairs, the graded pairs give prefetch_advisor_hit_rate (the
    reference's floor 0.7), and the replay estimator gives heat_observe_us
    (HEAT.observe_plan on a real query's recorded plan, best loop mean)
    over the real query's p50: heat_overhead_pct (target < 2%, printed)."""
    from pilosa_tpu_torch.api import API, QueryRequest
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.parallel.advisor import ADVISOR
    from pilosa_tpu_torch.parallel.engine import TorchEngine
    from pilosa_tpu_torch.util import plans
    from pilosa_tpu_torch.util.heat import HEAT

    rng = np.random.default_rng(19)
    holder = Holder(device=device)
    holder.open()
    view = holder.create_index("adv").create_field("f").view_if_not_exists("standard")
    rows = {}
    for s in range(ADV_SHARDS):
        frag = view.fragment_if_not_exists(s)
        for r in (0, 1, 8, 9):
            w = rng.integers(0, 1 << 63, 16384, dtype=np.uint64) | (
                rng.integers(0, 1 << 63, 16384, dtype=np.uint64) << np.uint64(1))
            rows.setdefault(r, []).append(w.copy())
            frag.load_row_words(r, w)
    for frag in view.fragments.values():
        frag.cache.invalidate()
    eng = TorchEngine(holder, device=device)
    eng.result_memo.maxsize = 0
    api = API(holder=holder, engine=eng)
    _reset_observers()
    req_a = QueryRequest("adv", "Count(Intersect(Row(f=0), Row(f=1)))")
    req_b = QueryRequest("adv", "Count(Intersect(Row(f=8), Row(f=9)))")
    want_a = int(and_popcounts(np.stack(rows[0]), np.stack(rows[1])).sum())
    want_b = int(and_popcounts(np.stack(rows[8]), np.stack(rows[9])).sum())

    def pair():
        if int(api.query(req_a).results[0]) != want_a or int(
                api.query(req_b).results[0]) != want_b:
            raise AssertionError("observe: an advisor-sweep Count disagrees with numpy")

    for _ in range(ADV_WARM_PAIRS + 1):
        pair()
    h0, m0 = ADVISOR.hits, ADVISOR.misses
    for _ in range(ADV_SCORE_PAIRS):
        pair()
    hits, misses = ADVISOR.hits - h0, ADVISOR.misses - m0
    if hits + misses <= 0:
        raise AssertionError("observe: the advisor graded nothing")
    out = {"prefetch_advisor_hit_rate": hits / (hits + misses), "hits": hits, "misses": misses}
    times = []
    resp = None
    for _ in range(ADV_P50_REPS):
        t0 = time.perf_counter()
        resp = api.query(req_a)
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    real = plans.STORE.find(resp.trace_id)
    if real is None:
        raise AssertionError("observe: the query's plan was not recorded")
    loop_n = max(1, ADV_REPLAY_N // ADV_REPLAY_LOOPS)
    for _ in range(loop_n // 10):
        HEAT.observe_plan(real)
    best = math.inf
    for _ in range(ADV_REPLAY_LOOPS):
        t0 = time.perf_counter()
        for _ in range(loop_n):
            HEAT.observe_plan(real)
        best = min(best, (time.perf_counter() - t0) / loop_n)
    doc = ADVISOR.to_doc()
    out.update(heat_observe_us=best * 1e6, query_p50_ms=p50 * 1e3,
               heat_overhead_pct=best / p50 * 100.0, advice_sets=doc["adviceSets"],
               learned_signatures=doc["learnedSignatures"])
    eng.close()
    holder.close()
    if out["prefetch_advisor_hit_rate"] < 0.7:
        raise AssertionError(f"observe: prefetch_advisor_hit_rate below 0.7: {out}")
    log(f"observe: prefetch_advisor_hit_rate {out['prefetch_advisor_hit_rate']:.4f} "
        f"({hits}/{hits + misses}); heat_observe_us {out['heat_observe_us']:.3f} over a "
        f"{out['query_p50_ms']:.4f} ms query p50: heat_overhead_pct "
        f"{out['heat_overhead_pct']:.4f}")
    return out


def history_path(device, seed):
    """bench.py's history section (bench.py:3380-3460) on the card, on a
    synthetic clock (one bucket per tick): history_tick_us (best loop mean
    of a sampler pass under live counters), history_sampler_overhead_pct
    (that over the 1 s interval), history_query_p50_ms (a 1 h /debug/history
    read).  Then the PQL read over _system on the card (history_cover)."""
    from pilosa_tpu_torch.api import API, QueryRequest
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.parallel.engine import TorchEngine
    from pilosa_tpu_torch.util.history import HistorySampler

    rng = np.random.default_rng(13)
    holder = Holder(device=device)
    holder.open()
    frag = holder.create_index("hov").create_field("f").view_if_not_exists(
        "standard").fragment_if_not_exists(0)
    ws = []
    for r in (0, 1):
        w = rng.integers(0, 1 << 63, 16384, dtype=np.uint64) | (
            rng.integers(0, 1 << 63, 16384, dtype=np.uint64) << np.uint64(1))
        ws.append(w.copy())
        frag.load_row_words(r, w)
    frag.cache.invalidate()
    eng = TorchEngine(holder, device=device)
    api = API(holder=holder, engine=eng)
    req = QueryRequest("hov", "Count(Intersect(Row(f=0), Row(f=1)))")
    want = int(and_popcounts(ws[0][None], ws[1][None]).sum())
    if int(api.query(req).results[0]) != want:
        raise AssertionError("observe: the history phase's Count disagrees with numpy")
    interval = 1.0
    hist = HistorySampler(api, node="chip", interval=interval)
    clock = [float(int(time.time()))]

    def tick_once():
        clock[0] += interval
        hist.tick(now=clock[0])

    tick_once()
    for _ in range(8):
        api.query(req)
        tick_once()
    loop_n = max(1, HIST_TICK_N // HIST_TICK_LOOPS)
    best = math.inf
    for _ in range(HIST_TICK_LOOPS):
        for _ in range(4):
            api.query(req)
        t0 = time.perf_counter()
        for _ in range(loop_n):
            tick_once()
        best = min(best, (time.perf_counter() - t0) / loop_n)
    for _ in range(HIST_SEED_TICKS):
        tick_once()
    now = clock[0]
    reads = []
    doc = None
    for _ in range(HIST_READ_REPS):
        t0 = time.perf_counter()
        doc = hist.query("pilosa_query_seconds_rate", since=now - 3600.0, until=now)
        reads.append(time.perf_counter() - t0)
    if not any(doc["points"].values()):
        raise AssertionError("observe: the 1 h history read found no point")
    out = {"history_tick_us": best * 1e6, "history_sampler_overhead_pct": best / interval * 100.0,
           "history_query_p50_ms": statistics.median(reads) * 1e3,
           "series": len(hist.series_names())}
    eng.close()
    holder.close()
    out.update(history_cover(device))
    log(f"observe: history_tick_us {out['history_tick_us']:.1f} ({out['series']} series), "
        f"history_sampler_overhead_pct {out['history_sampler_overhead_pct']:.4f}, "
        f"history_query_p50_ms {out['history_query_p50_ms']:.4f}")
    return out


def history_cover(device, interval=60.0, per_hour=(3, 5, 2)):
    """The history's PQL read on the card: a sampler (3 h retention) ticks
    on a synthetic clock through three hour views, ``per_hour`` ticks in
    each, and ``Sum(Range(samples=<sid>, S, E), field=<family>)`` over the
    middle hour alone goes through ``Executor.execute``: K6 with that hour
    view's time cover as its filter.  It must equal the sum of ``query``'s
    points over that hour, differ from the sum over all three, launch K6
    and take no host fallback."""
    import datetime as dt

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.parallel import bsi
    from pilosa_tpu_torch.parallel.engine import TorchEngine
    from pilosa_tpu_torch.util.history import HistorySampler

    card = device.type == "cuda"
    holder = Holder(device=device)
    holder.open()
    eng = TorchEngine(holder, device=device)
    api = API(holder=holder, engine=eng)
    hist = HistorySampler(api, node="chip", interval=interval, retention=3 * 3600.0)
    h0 = math.floor(time.time() / 3600.0) * 3600.0 - 3 * 3600.0
    for h, n in enumerate(per_hour):
        for k in range(n):
            hist.tick(now=h0 + h * 3600.0 + 600.0 + k * interval)
    now = h0 + 2 * 3600.0 + 600.0 + (per_hour[2] - 1) * interval
    if len(hist.snapshot()["hourViews"]) != len(per_hour):
        raise AssertionError(f"observe: the history's hour views {hist.snapshot()['hourViews']}")
    family = "pilosa_history_ticks_total_rate"
    sid = hist._series[family]["_"]

    def hour(ts):
        return dt.datetime.fromtimestamp(ts, dt.timezone.utc).strftime("%Y-%m-%dT%H:%M")

    def points(since, until):
        pts = hist.query(family, since=since, until=until)["points"]["_"]
        return sum(v for _, v in pts), len(pts)

    lo, hi = h0 + 3600.0, h0 + 2 * 3600.0  # the middle hour; Range's end is exclusive
    want, every = points(lo, hi - interval), points(h0, now)
    q = f"Sum(Range(samples={sid}, {hour(lo)}, {hour(hi)}), field={family})"
    k6_0, fb0, efb0 = bsi.sum_tree_cuda.launches, api.executor.host_fallbacks, eng.host_fallbacks
    r = api.executor.execute("_system", q).results[0]
    got = (r.val, r.count)
    out = {"pql_sum": list(got), "query_points_sum": list(want), "all_hours_sum": list(every),
           "k6_launches": bsi.sum_tree_cuda.launches - k6_0,
           "host_fallbacks": api.executor.host_fallbacks - fb0 + eng.host_fallbacks - efb0}
    eng.close()
    holder.close()
    if got != want or not want[1] or want == every:
        raise AssertionError(f"observe: PQL {q} = {got}, the sampler's points over that hour "
                             f"{want}, over all three {every}")
    if out["host_fallbacks"] or (card and out["k6_launches"] <= 0):
        raise AssertionError(f"observe: the _system Sum took the host lane or no K6: {out}")
    log(f"observe: {q} = {got} = the sampler's points over that hour (all three hours: "
        f"{every}), K6 {out['k6_launches']}, host fallbacks 0")
    return out


def _poll(what, fn, timeout):
    """fn() until it returns a true value (at most ``timeout`` seconds)."""
    t0 = time.perf_counter()
    while True:
        v = fn()
        if v:
            return v
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"observe: {what} within {timeout} s")
        time.sleep(0.1)


def observe_node(node_cmd=None, workers=2):
    """``python -m pilosa_tpu_torch server`` with ``[server] workers = 2``,
    ``[observability] history = true`` (1 s samples, an error-rate SLO),
    ``[metric] service = statsd`` at a UDP socket this script holds and a
    device budget of three rows.  The reference's heat recipe through the
    node: rows 0/1/8/9 of one field, dashboards A = 0 AND 1 and B = 8 AND 9
    alternating; /debug/heat ranks exactly those rows with a residency gap
    seen, /debug/prefetch_advice holds its hints and hit rate, /metrics the
    heat gauges and the advisor counters, /debug/history the gap's nonzero
    points.  Then the SLO: a serve-side error rule posted to /debug/faults,
    queries until /debug/events holds slo.burn, /readyz 200 with the
    degraded reason, a bundle at /debug/flightrecorder and under
    .flightrec/; the rule healed, queries until slo.clear.  The
    OpenMetrics exposition carries exemplars and # EOF, statsd datagrams
    arrived; SIGTERM, exit 0."""
    import shutil
    import socket

    from pilosa_tpu_torch.net import InternalClient
    from pilosa_tpu_torch.net.client import ClientError

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "observe_node")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_dir, log_path = os.path.join(work, "data"), os.path.join(work, "node.log")
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.setblocking(False)
    cfg = os.path.join(work, "observe.toml")
    with open(cfg, "w") as f:
        f.write(f"[server]\nworkers = {workers}\n\n"
                f"[engine]\ndevice-budget-bytes = {3 * (32768 * 4 + 16)}\n\n"
                f"[metric]\nservice = \"statsd\"\nhost = \"127.0.0.1:{sock.getsockname()[1]}\"\n\n"
                f"[observability]\nhistory = true\nsample-interval = \"1s\"\n"
                f"slo-error-rate = 0.01\nslo-window = \"{int(OBS_SLO_WINDOW_S)}s\"\n")
    cmd = node_cmd or [sys.executable, "-m", "pilosa_tpu_torch"]
    port = _free_port()
    out = {"workers": workers}
    t0 = time.perf_counter()
    proc = _start_node(cmd, data_dir, port, log_path, extra=["-c", cfg])
    try:
        out["ready_s"], _ = _wait_ready(proc, port, log_path, "with history and workers")
        c = InternalClient(f"http://localhost:{port}", timeout=120)
        c.create_index("i")
        c.create_field("i", "f")
        rng = np.random.default_rng(23)
        cols = {r: np.sort(rng.choice(1 << 20, 20000, replace=False)) for r in (0, 1, 8, 9)}
        c.import_bits("i", "f", 0, [r for r in cols for _ in cols[r]],
                      [int(x) for r in cols for x in cols[r]])
        qa, qb = "Count(Intersect(Row(f=0), Row(f=1)))", "Count(Intersect(Row(f=8), Row(f=9)))"
        wa, wb = len(np.intersect1d(cols[0], cols[1])), len(np.intersect1d(cols[8], cols[9]))
        gap_max = 0
        for _ in range(6):
            for q, w in ((qa, wa), (qb, wb)):
                got = c.query("i", q)["results"][0]
                if got != w:
                    raise AssertionError(f"observe: node {q} = {got}, numpy {w}")
                doc = c._get("/debug/heat?index=i&field=f&topk=8")
                gap_max = max([gap_max] + [t["gapBytes"] for t in doc["tables"]])
        heat = c._get("/debug/heat?index=i&field=f&topk=8")
        tab = heat["tables"][0]
        if sorted(r["row"] for r in tab["topRows"]) != [0, 1, 8, 9] or tab["hotRows"] != 4:
            raise AssertionError(f"observe: /debug/heat does not rank rows 0, 1, 8, 9: {tab}")
        if gap_max <= 0:
            raise AssertionError("observe: /debug/heat never showed a residency gap")
        out["heat"] = {"hotRows": tab["hotRows"], "gapBytes_max": gap_max,
                       "topRows": [r["row"] for r in tab["topRows"]]}
        c.query("i", qa)
        adv = c._get("/debug/prefetch_advice")
        if not adv["outstanding"] or adv["hitRate"] is None:
            raise AssertionError(f"observe: /debug/prefetch_advice holds no advice: {adv}")
        out["advice"] = {"hints": [h["rows"] for h in adv["outstanding"]["hints"]],
                         "hitRate": adv["hitRate"], "drivenRequests": adv["drivenRequests"]}
        metrics = c.metrics()
        for name in ("pilosa_engine_heat_tracked_rows", "pilosa_engine_residency_gap_bytes",
                     "pilosa_advisor_predictions_total", "pilosa_advisor_hits_total",
                     "pilosa_advisor_misses_total"):
            if f"\n{name}" not in metrics:
                raise AssertionError(f"observe: /metrics lacks {name}")

        def gap_points():
            doc = c._get("/debug/history?series=pilosa_engine_residency_gap_bytes")
            pts = [v for series in doc["points"].values() for _, v in series]
            return pts if any(pts) else None

        out["history_gap_points"] = len(_poll("no nonzero residency-gap point in the history",
                                              gap_points, 15.0))
        # The SLO: errors injected on the served side, then healed.
        c._post("/debug/faults", {"seed": 1,
                                  "rules": ["error peer=serve route=/index/* status=503"]})
        burst = InternalClient(f"http://localhost:{port}", timeout=30, retries=0)

        def hammer():
            # A worker sends a query to the owner as a decoded frame, past
            # the serve-side intercept (as the reference's does); every
            # other route passes through to the owner's handler, which
            # applies it.  So the drill reads the index's schema.
            for _ in range(20):
                try:
                    burst._get("/index/i")
                except ClientError as e:
                    if e.code != 503:
                        raise

        def burned():
            hammer()
            evs = c._get("/debug/events?type=slo")["events"]
            return [e for e in evs if e["type"] == "slo.burn"]

        t_burn = time.perf_counter()
        _poll("no slo.burn in /debug/events", burned, 30.0)
        out["burn_s"] = time.perf_counter() - t_burn
        ready = c._get("/readyz")
        if ready.get("degraded") != ["slo:error_rate"]:
            raise AssertionError(f"observe: /readyz is not degraded: {ready}")
        bundle = c._get("/debug/flightrecorder")
        if bundle.get("kind") != "flightrecorder" or "history" not in bundle:
            raise AssertionError(f"observe: /debug/flightrecorder: {sorted(bundle)}")
        fr = os.path.join(data_dir, ".flightrec")
        persisted = sorted(os.listdir(fr)) if os.path.isdir(fr) else []
        if not persisted:
            raise AssertionError("observe: no flight-recorder bundle under .flightrec/")
        faults = c._get("/debug/faults")
        out["slo"] = {"degraded": ready["degraded"], "bundles": persisted,
                      "injected": faults["rules"][0]["injected"],
                      "bundle_keys": sorted(bundle)}
        c._post("/debug/faults", {"rules": []})

        def cleared():
            for _ in range(10):
                if c.query("i", qb)["results"][0] != wb:
                    raise AssertionError("observe: a Count after the heal disagrees")
            evs = c._get("/debug/events?type=slo")["events"]
            return [e for e in evs if e["type"] == "slo.clear"]

        t_clear = time.perf_counter()
        _poll("no slo.clear after the heal", cleared, OBS_SLO_WINDOW_S + 20.0)
        out["clear_s"] = time.perf_counter() - t_clear
        if c._get("/readyz").get("degraded") != []:
            raise AssertionError("observe: /readyz still degraded after slo.clear")
        status, text = _openmetrics(port)
        lines = text.splitlines()
        ex = [ln for ln in lines if ln.startswith("pilosa_query_seconds_bucket")
              and ' # {trace_id="' in ln]
        if status != 200 or not ex or lines[-1] != "# EOF":
            raise AssertionError(f"observe: the OpenMetrics exposition ({status}) lacks "
                                 "exemplars or # EOF")
        out["exemplars"] = len(ex)
        grams = []
        while True:
            try:
                grams.append(sock.recv(65536))
            except BlockingIOError:
                break
        if not grams:
            raise AssertionError("observe: no statsd datagram arrived")
        out["statsd_datagrams"] = len(grams)
        out["statsd_sample"] = grams[0].decode(errors="replace")[:80]
        _stop_node(proc, log_path)
    finally:
        sock.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["seconds"] = time.perf_counter() - t0
    log(f"observe: node with {workers} workers ready in {out['ready_s']:.3f} s; heat "
        f"{out['heat']}; advice {out['advice']}; {out['history_gap_points']} gap points in "
        f"the history; slo.burn after {out['burn_s']:.3f} s (degraded {out['slo']['degraded']}, "
        f"bundles {out['slo']['bundles']}), slo.clear {out['clear_s']:.3f} s after the heal; "
        f"{out['exemplars']} exemplars; {out['statsd_datagrams']} statsd datagrams; "
        f"{out['seconds']:.3f} s")
    return out


def _openmetrics(port):
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=60)
    try:
        conn.request("GET", "/metrics", headers={"Accept": "application/openmetrics-text"})
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def run_observe_path(device, seed, keep, node_cmd=None):
    """The observe phase (after residency, before the writes): promote-ahead
    at equal budget on the residency phase's rsw holder (``keep``), the
    advisor sweep, the history on the card and the node.  Every kernel
    wrapper's count is set to 0 first and read at the end, in this
    process (the node's device owner is another): K1P (the A/B's warm
    arrivals) and K6 (the _system Sum) must have launched.  Closes
    the rsw holder.  Returns the phase's numbers and its launches."""
    import torch

    card = device.type == "cuda"
    t0 = time.perf_counter()
    zero_counts()
    out = {"card": card_line()}
    try:
        out["advisor_ab"] = advisor_ab(device, keep["holder"], keep["words"])
    finally:
        keep["holder"].close()
        keep.clear()
        gc.collect()
        if card:
            torch.cuda.empty_cache()
    out["advisor_sweep"] = advisor_sweep(device, seed)
    out["history"] = history_path(device, seed)
    out["node"] = observe_node(node_cmd)
    _reset_observers()
    out["launches"] = read_counts()
    if card and min(out["launches"][k] for k in ("count_tree_pool", "sum_tree")) <= 0:
        raise AssertionError(f"observe: K1P or K6 never launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"observe: launches {json.dumps(out['launches'])}; {out['seconds']:.3f} s")
    return out


# -- the repair phase: repair-on-write of a dashboard under ingest --------------
# (bench.py:1891-2090, bench.py --repair-sweep)

RPS_SEED = 16  # bench.py repair_sweep's rng
RPS_SEG_ROWS = 16  # bench.py RPS_SEG_ROWS
RPS_BUILD_BITS = 4000  # bench.py RPS_BUILD_BITS: seg bits per shard
RPS_ROUNDS = 12  # bench.py RPS_ROUNDS
RPS_WRITES_PER_ROUND = 64  # bench.py RPS_WRITES_PER_ROUND: bits per touched shard
RPS_READS_PER_ROUND = 5  # bench.py RPS_READS_PER_ROUND: timed serves per write burst
RPS_IDLE_REPS = 24  # bench.py RPS_IDLE_REPS
RPS_DASHBOARD = (  # bench.py repair_sweep's dashboard
    "Count(Intersect(Row(seg=1), Row(seg=2)))",
    "Count(Union(Row(seg=3), Row(seg=4), Row(seg=5)))",
    "TopN(seg, n=8)",
    "GroupBy(Rows(field=g1), Rows(field=g2))",
    "Sum(field=v)",
)
# K1, K6 and K8: the kernels a recompute of the dashboard launches (the
# no-src TopN is a host reduce); a repaired serve launches none of them.
RPS_KERNELS = ("count_tree_dense", "sum_tree", "groupn_tree")


def run_repair_path(device, n_shards=N_SHARDS, seed=RPS_SEED):
    """The repair phase (after observe, before the writes): bench.py's
    repair sweep on a holder of its own at ``n_shards`` (bench.py: 8)
    with every other parameter of bench.py's.  Index rpw: seg 16 rows of
    4000 bits a shard, g1 6 rows and g2 5 of 800, v int 0..1023 with 600
    values Set through the executor.  The five-query dashboard (two
    Counts, TopN(seg, n=8), GroupBy(g1, g2), Sum(field=v)) serves 24
    times idle from the memo, then 12 write rounds: 64 bits into each of
    2 seg shards by bulk_import, one Set in g1 or g2 and one of v, and
    every third round a load_row_words of seg (OPAQUE: the repair layer
    must fall back).  Five timed serves a round, and each round's served
    answers must equal a recompute with the repair layer suspended and
    the memo cleared.  In each round with no OPAQUE write, the first
    serve (the one that repairs) launches no kernel at all, and the
    recompute launches K1, K6 and K8.  Prints bench.py's four numbers
    (result_memo_hit_rate_under_write_load, at least 0.9;
    dashboard_p50_under_ingest_vs_idle, bench.py's target 1.5;
    repair_touched_words_per_repair; dashboard_repair_serve_p50_ms) and
    the recompute arm's p50.  Every kernel count is set to 0 before the
    phase and read after it (repair_launches: the recompute arm's, as the
    served ones launch nothing).  Frees its holder at the end.  Returns
    the phase's numbers and launches."""
    import torch

    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.net.wire import result_to_json
    from pilosa_tpu_torch.parallel.engine import TorchEngine

    card = device.type == "cuda"
    t_phase = time.perf_counter()
    zero_counts()
    out = {"card": card_line(), "shards": n_shards}
    rng = np.random.default_rng(seed)
    holder = Holder(device=device)
    holder.open()
    idx = holder.create_index("rpw")
    for name in ("seg", "g1", "g2"):
        idx.create_field(name)
    idx.create_field("v", FieldOptions(type="int", min=0, max=1023))
    shards = range(n_shards)
    seg_view = idx.field("seg").view_if_not_exists("standard")
    for sh in shards:
        seg_view.fragment_if_not_exists(sh).bulk_import(
            rng.integers(0, RPS_SEG_ROWS, RPS_BUILD_BITS),
            rng.integers(0, 1 << 20, RPS_BUILD_BITS))
    for fname, nrows in (("g1", 6), ("g2", 5)):
        gview = idx.field(fname).view_if_not_exists("standard")
        for sh in shards:
            gview.fragment_if_not_exists(sh).bulk_import(
                rng.integers(0, nrows, 800), rng.integers(0, 1 << 20, 800))
    engine = TorchEngine(holder, device=device)
    ex = Executor(holder, engine=engine)

    def q(text):
        return ex.execute("rpw", text).results[0]

    for col in rng.integers(0, n_shards << 20, 600):
        q(f"Set({int(col)}, v={int(rng.integers(0, 1024))})")
    # bench.py's 600 values cover its 8 shards; over 960 they leave about
    # half the shards with no v and no existence fragment, and a round's
    # Set into such a shard would create one, which moves the index's
    # shard epoch and drops every entry (as the reference does).  So every
    # shard gets its (empty) v and existence fragments here: no bit and no
    # answer changes.
    for view in (idx.field("v").view_if_not_exists("bsig_v"),
                 idx.existence_field().view_if_not_exists("standard")):
        for sh in shards:
            view.fragment_if_not_exists(sh)
    out["build_s"] = time.perf_counter() - t_phase

    def dash(times=None):
        got = []
        for text in RPS_DASHBOARD:
            t0 = time.perf_counter()
            got.append(result_to_json(q(text)))
            if times is not None:
                times.setdefault(text, []).append(time.perf_counter() - t0)
        return got

    def recompute():
        with engine.repairs.suspended():
            engine.result_memo.clear()
            return dash()

    def memo_tally():
        return engine.result_memo.hits, engine.result_memo.misses

    def sync():
        if card:
            torch.cuda.synchronize()

    try:
        base = dash()
        if base != recompute():
            raise AssertionError("repair: the idle dashboard disagrees with its recompute")
        h0, m0 = memo_tally()
        caches0 = engine.cache_snapshot()["caches"]
        idle = []
        for _ in range(RPS_IDLE_REPS):
            t0 = time.perf_counter()
            got = dash()
            idle.append(time.perf_counter() - t0)
            if got != base:
                raise AssertionError("repair: an idle serve disagrees with the first")
        h1, m1 = memo_tally()
        rate_idle = (h1 - h0) / max((h1 - h0) + (m1 - m0), 1)
        # The idle serves' hits per memo cache, from the engine's tallies
        # (the pilosa_engine_cache_* series): the Sum, the TopN and the
        # GroupBy each from its own memo_* cache.
        caches1 = engine.cache_snapshot()["caches"]
        memo_idle = {k: {hm: caches1[k][hm] - caches0[k][hm] for hm in ("hits", "misses")}
                     for k in ("result_memo", "memo_sum", "memo_topn", "memo_groupby")}
        if min(memo_idle[k]["hits"] for k in ("memo_sum", "memo_groupby")) < RPS_IDLE_REPS:
            raise AssertionError(f"repair: the idle serves' memo tallies {memo_idle}")
        t_idle = statistics.median(idle)

        rep0 = sum(engine.repairs.repaired.values())
        fb0 = sum(engine.repairs.fallbacks.values())
        tw0 = engine.repairs.touched_words
        times, first_times, recompute_times = [], [], []
        hits_acc = miss_acc = forced_stale = 0
        served_launches, recompute_launches = [], []
        repair_by_query = {}  # each query's time in the serves that repair
        for rnd in range(RPS_ROUNDS):
            for sh in rng.choice(n_shards, 2, replace=False):
                holder.fragment("rpw", "seg", "standard", int(sh)).bulk_import(
                    rng.integers(0, RPS_SEG_ROWS, RPS_WRITES_PER_ROUND),
                    rng.integers(0, 1 << 20, RPS_WRITES_PER_ROUND))
            gf = "g1" if rnd % 2 else "g2"
            gs = int(rng.integers(0, n_shards))
            holder.fragment("rpw", gf, "standard", gs).set_bit(
                int(rng.integers(0, 5)), (gs << 20) + int(rng.integers(0, 1 << 20)))
            q(f"Set({int(rng.integers(0, n_shards << 20))}, v={int(rng.integers(0, 1024))})")
            opaque = rnd % 3 == 2
            if opaque:
                holder.fragment("rpw", "seg", "standard", 0).load_row_words(
                    0, _rand64(rng, 1)[0] & _rand64(rng, 1)[0])
                forced_stale += 1
            hb, mb = memo_tally()
            sync()
            served = None
            for rep in range(RPS_READS_PER_ROUND):
                if rep == 0:
                    before = read_counts()
                t0 = time.perf_counter()
                served = dash(repair_by_query if rep == 0 and not opaque else None)
                dt = time.perf_counter() - t0
                times.append(dt)
                if rep == 0:
                    first_times.append(dt)
                    moved = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
                    if not opaque:
                        served_launches.append(moved)
                        if moved:
                            raise AssertionError(f"repair: round {rnd}'s repaired serve "
                                                 f"launched {moved}")
            ha, ma = memo_tally()
            hits_acc += ha - hb
            miss_acc += ma - mb
            before = read_counts()
            sync()
            t0 = time.perf_counter()
            want = recompute()
            sync()
            recompute_times.append(time.perf_counter() - t0)
            moved = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
            recompute_launches.append(moved)
            if card and min(moved.get(k, 0) for k in RPS_KERNELS) <= 0:
                raise AssertionError(f"repair: round {rnd}'s recompute did not launch "
                                     f"K1, K6 and K8: {moved}")
            if served != want:
                raise AssertionError(f"repair: round {rnd}: served != recompute\n"
                                     f"  served: {served}\n  want:   {want}")
        repaired = sum(engine.repairs.repaired.values()) - rep0
        fallbacks = sum(engine.repairs.fallbacks.values()) - fb0
        touched = engine.repairs.touched_words - tw0
        rate_w = (hits_acc + repaired) / max(hits_acc + miss_acc, 1)
        t_write = statistics.median(times)
        if repaired <= 0:
            raise AssertionError("repair: no repair ever served")
        if fallbacks < forced_stale:
            raise AssertionError(f"repair: {fallbacks} fallbacks for {forced_stale} OPAQUE rounds")
        if rate_w < 0.9:
            raise AssertionError(f"repair: result_memo_hit_rate_under_write_load {rate_w} < 0.9")
        out.update({
            "result_memo_hit_rate_under_write_load": rate_w,
            "memo_hit_rate_idle": rate_idle,
            "memo_caches_idle": memo_idle,
            "engine_caches": {k: v for k, v in engine.cache_snapshot()["caches"].items()
                              if k.startswith("memo_") or k == "result_memo"},
            "dashboard_p50_under_ingest_vs_idle": t_write / t_idle,
            "repair_touched_words_per_repair": touched / max(repaired, 1),
            "dashboard_repair_serve_p50_ms": statistics.median(first_times) * 1e3,
            "dashboard_recompute_p50_ms": statistics.median(recompute_times) * 1e3,
            "dashboard_idle_p50_ms": t_idle * 1e3,
            "dashboard_write_rounds_p50_ms": t_write * 1e3,
            "repair_serve_p50_ms_by_query": {k: statistics.median(v) * 1e3
                                             for k, v in repair_by_query.items()},
            "repaired": repaired, "fallbacks": fallbacks, "forced_stale": forced_stale,
            "touched_words": touched,
            "repaired_by_kind": dict(engine.repairs.repaired),
            "fallbacks_by_kind": dict(engine.repairs.fallbacks),
            "hub": engine.repairs.snapshot()["hub"],
            "served_launches": served_launches,
            "recompute_launches_round0": recompute_launches[0],
            "stack_updates": engine.stack_updates,
            "stack_rebuilds": engine.stack_rebuilds,
        })
    finally:
        engine.close()
        holder.close()
        del engine, ex, holder
        gc.collect()
        if card:
            torch.cuda.empty_cache()
    out["launches"] = read_counts()
    if card and min(out["launches"][k] for k in RPS_KERNELS) <= 0:
        raise AssertionError(f"repair: K1, K6 or K8 never launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"repair: result_memo_hit_rate_under_write_load {out['result_memo_hit_rate_under_write_load']:.4f} "
        f"(idle {rate_idle:.4f}), dashboard_p50_under_ingest_vs_idle "
        f"{out['dashboard_p50_under_ingest_vs_idle']:.4f} (bench.py's target 1.5), "
        f"repair_touched_words_per_repair {out['repair_touched_words_per_repair']:.1f}, "
        f"dashboard_repair_serve_p50_ms {out['dashboard_repair_serve_p50_ms']:.4f}, "
        f"dashboard_recompute_p50_ms {out['dashboard_recompute_p50_ms']:.4f}; repaired "
        f"{repaired}, fallbacks {fallbacks} (forced {forced_stale}); every round exact "
        f"against its recompute; {n_shards} shards, {out['seconds']:.3f} s; {out['card']}")
    return out


def bitops_popcount(words, gate):
    from pilosa_tpu_torch.ops import bitops

    return bitops.popcount_words(words[gate != 0]).sum()


# -- the http phase: the HTTP node (bench.py:804-1283) ------------------------

HTTP_REPS = 30  # bench.py HTTP_REPS: sequential requests of the c2 texts
QPS_CONNS, QPS_PER_CONN = 640, 32  # bench.py run_qps: one client process
WARM_TIERS = (1, 9, 65, 257)  # bench.py:943-946
NODE_SHARDS = N_SHARDS_10M  # the node's b10m: config 2's 10 shards
NODE_READY_S = 60.0

# bench.py's raw-socket load generator (bench.py:868-910), one process of
# many persistent connections, and every reply checked: status 200 and the
# body's results equal to the oracle's (the bytes before its traceID).
QPS_CLIENT = r"""
import json, socket, sys, threading, time
port, n_threads, per_conn = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
doc = json.loads(sys.stdin.read())
texts, wants = doc["texts"], [w.encode() for w in doc["wants"]]

def build(body):
    b = body.encode()
    return (b"POST /index/b10m/query HTTP/1.1\r\nHost: l\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(b)).encode() + b"\r\n\r\n" + b)

reqs = [build(t) for t in texts]
done, bad = [], []
lock = threading.Lock()

def worker(tid):
    n = 0
    try:
        s = socket.create_connection(("localhost", port), timeout=300)
        f = s.makefile("rb")
        for j in range(per_conn):
            k = (tid * per_conn + j) % len(reqs)
            s.sendall(reqs[k])
            line = f.readline()
            clen = 0
            while True:
                h = f.readline()
                if h in (b"\r\n", b""):
                    break
                if h.lower().startswith(b"content-length:"):
                    clen = int(h.split(b":")[1])
            body = f.read(clen)
            rest = body[len(wants[k]):]
            if (not line.startswith(b"HTTP/1.1 200") or not body.startswith(wants[k])
                    or not rest.startswith(b', "traceID": "')):
                with lock:
                    bad.append([texts[k], line.decode(errors="replace"),
                                body[:200].decode(errors="replace")])
            n += 1
        s.close()
    except Exception as e:
        with lock:
            bad.append(["worker", repr(e), ""])
    finally:
        with lock:
            done.append(n)

threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
t0 = time.perf_counter()
for t in threads: t.start()
for t in threads: t.join()
print(json.dumps({"n": sum(done), "seconds": time.perf_counter() - t0, "bad": len(bad),
                  "first_bad": bad[:3]}))
"""


def _results_prefix(results):
    """The bytes a query response starts with: ``{"results": [...]`` as
    the node's JSON encoder writes them."""
    return '{"results": ' + json.dumps(results)


def run_qps(port, texts, wants, conns=QPS_CONNS, per_conn=QPS_PER_CONN):
    """bench.py's QPS loop: one client subprocess, ``conns`` connections
    of ``per_conn`` requests each; every reply 200 and exact.  Returns
    (queries/s, requests)."""
    payload = json.dumps({"texts": texts, "wants": [_results_prefix(w) for w in wants]})
    proc = subprocess.run([sys.executable, "-c", QPS_CLIENT, str(port), str(conns),
                           str(per_conn)], input=payload, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"http: the QPS client failed: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    if out["bad"] or out["n"] != conns * per_conn:
        raise AssertionError(f"http: {out['bad']} bad replies of {out['n']}: {out['first_bad']}")
    return out["n"] / out["seconds"], out["n"]


def _http_launches():
    return read_counts(HTTP_KERNELS)


def _zero_http_launches():
    from pilosa_tpu_torch.parallel import kernels

    zero_counts(HTTP_KERNELS)
    kernels.count_batch_tree_cuda.by_k.clear()


def _frag_words(holder, index, field, view, rows, n_shards):
    """{row: uint64[S, W64]}: the words the fragments hold."""
    return {r: np.stack([holder.fragment(index, field, view, s).row_words(r).view(np.uint64)
                         for s in range(n_shards)]) for r in rows}


def c2_queries(w10):
    """bench.py's c2 texts (32 four-row trees on b10m) and their counts."""
    texts, wants = [], []
    for k in range(len(F10_ROWS) // 4):
        a = 100 + 4 * k
        texts.append(f"Count(Xor(Difference(Union(Row(f={a}), Row(f={a + 1})), "
                     f"Row(f={a + 2})), Row(f={a + 3})))")
        wants.append([int(popcounts(((w10[a] | w10[a + 1]) & ~w10[a + 2]) ^ w10[a + 3]).sum())])
    return texts, wants


def dense_roaring(rows):
    """Pilosa-roaring bytes of dense rows ({row: uint64[W64]}, each of its
    16 containers over 4096 bits): one bitmap container per 2^16 bits, the
    in-fragment positions row * 2^20 + column, as import-roaring takes
    them (codec.serialize over 2^20 positions a row would cost seconds)."""
    import struct

    from pilosa_tpu_torch.roaring import codec

    heads, pays = [], []
    for r in sorted(rows):
        w = rows[r].reshape(16, 1024)
        cnt = np.bitwise_count(w).sum(axis=1)
        for c in range(16):
            if cnt[c] <= codec.ARRAY_MAX_SIZE:
                raise AssertionError("dense_roaring: a sparse container")
            heads.append(struct.pack("<QHH", r * 16 + c, codec.CONTAINER_BITMAP, int(cnt[c]) - 1))
            pays.append(w[c].astype("<u8").tobytes())
    out = bytearray(struct.pack("<II", codec.COOKIE, len(heads)))
    out += b"".join(heads)
    off = codec.HEADER_BASE_SIZE + len(heads) * 16
    for p in pays:
        out += struct.pack("<I", off)
        off += len(p)
    out += b"".join(pays)
    return bytes(out)


def _http_post(port, index, body, headers=None, timeout=300, path_suffix=""):
    import urllib.request

    req = urllib.request.Request(f"http://localhost:{port}/index/{index}/query{path_suffix}",
                                 data=body if isinstance(body, bytes) else body.encode(),
                                 method="POST")
    req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _http_results(port, index, text, want, what):
    """One query over HTTP: 200, a traceID, and the results equal to
    ``want``."""
    status, ctype, body = _http_post(port, index, text)
    doc = json.loads(body)
    if status != 200 or ctype != "application/json" or "traceID" not in doc:
        raise AssertionError(f"http: {what}: {status} {ctype} {body[:200]!r}")
    if want is not None and doc["results"] != want:
        raise AssertionError(f"http: {what}: port {doc['results']} != numpy oracle {want}")
    return doc


def _seq_p50(port, texts, wants, reps=HTTP_REPS):
    """bench.py's http_count_e2e_p50: ``reps`` sequential urllib requests
    of the c2 texts, each answer checked; the median in ms."""
    lat = []
    for i in range(reps):
        k = i % len(texts)
        t0 = time.perf_counter()
        _, _, body = _http_post(port, "b10m", texts[k])
        lat.append((time.perf_counter() - t0) * 1e3)
        if json.loads(body)["results"] != wants[k]:
            raise AssertionError(f"http: {texts[k]}: {body[:200]!r} != {wants[k]}")
    return statistics.median(lat)


CQ_INDEX = "cqi"  # the continuous queries' own index: no other phase reads it
CQ_SHARDS = N_SHARDS_10M
CQ_WAIT_MS = 5000


def _cq_req(port, method, path, body=None, timeout=60):
    """(status, JSON document) of one request to the node."""
    import urllib.error
    import urllib.request

    data = None if body is None else (body if isinstance(body, bytes) else body.encode())
    req = urllib.request.Request(f"http://localhost:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def build_cq_index(holder, seed):
    """Index cqi over 10 shards: rows 1 and 2 of f with 2^15 bits a shard,
    row 3 with 64, each column in the existence field too, as an import
    through the API marks it (a Set into a shard whose existence fragment
    does not exist yet creates it, which moves the index's shard epoch:
    every memo entry and repair entry of the index then starts over).
    Returns {row: sorted columns}."""
    rng = np.random.default_rng(seed + 47)
    idx = holder.create_index(CQ_INDEX)
    f = idx.create_field("f")
    cols = {}
    for r, n in ((1, 1 << 15), (2, 1 << 15), (3, 64)):
        cols[r] = np.unique(np.concatenate([
            (sh << 20) + rng.choice(1 << 20, n, replace=False) for sh in range(CQ_SHARDS)]))
        f.import_bulk(np.full(cols[r].size, r), cols[r])
    every = np.unique(np.concatenate(list(cols.values())))
    idx.existence_field().import_bulk(np.zeros(every.size, dtype=np.int64), every)
    return cols


def cq_cols_of(holder):
    """{row: sorted columns} of cqi's f, read from its fragments."""
    return {r: np.concatenate([
        (sh << 20) + holder.fragment(CQ_INDEX, "f", "standard", sh).row_positions(r).astype(
            np.int64) for sh in range(CQ_SHARDS)]) for r in (1, 2, 3)}


# The kernels a Count over HTTP can launch (K1, K2, K5), by the names the
# profiler gives them.
COUNT_KERNEL_NAMES = ("count_tree_dense_kernel", "count_tree_blocks_kernel",
                      "count_batch_tree_kernel")


def debug_routes_http(port, engine, texts, wants, topn_want, cuda, seconds=1.5):
    """The routes this node ports from item 14, over HTTP: POST
    /recalculate-caches (a TopN exact after it); POST /debug/pprof/trace
    captured while a thread sends the c2 Counts (every answer checked,
    the memo off), whose Chrome trace must name the Count kernels on the
    card; /debug/pprof/profile and /debug/pprof/heap; and /debug/vars'
    engineCaches.caches under the reference's names.  Returns its
    numbers."""
    import threading

    from pilosa_tpu_torch.util.stats import ENGINE_CACHES

    out = {}
    status, doc = _cq_req(port, "POST", "/recalculate-caches", b"")
    if (status, doc) != (200, {}):
        raise AssertionError(f"http: /recalculate-caches answered {status} {doc}")
    _http_results(port, "bench", "TopN(top, Row(f=10), n=5)", topn_want,
                  "TopN after /recalculate-caches")
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pprof_trace")
    stop, sent, errors = threading.Event(), [0], []

    def counts():
        try:
            while not stop.is_set():
                k = sent[0] % len(texts)
                _http_results(port, "b10m", texts[k], wants[k], "a Count during the trace")
                sent[0] += 1
        except Exception as e:  # noqa: BLE001 — reported after the capture
            errors.append(e)

    with memo_off(engine):
        t = threading.Thread(target=counts, daemon=True)
        t.start()
        try:
            status, doc = _cq_req(port, "POST",
                                  f"/debug/pprof/trace?seconds={seconds}&dir={trace_dir}", b"")
        finally:
            stop.set()
            t.join(120)
    if errors or status != 200:
        raise AssertionError(f"http: the trace: {status} {doc} {errors[:1]}")
    with open(doc["traceFile"]) as f:
        events = json.load(f)["traceEvents"]
    named = {n: sum(1 for e in events if n in e.get("name", "")) for n in COUNT_KERNEL_NAMES}
    out["pprof_trace"] = {"counts_sent": sent[0], "events": len(events), "kernels": named,
                          "trace_mb": os.path.getsize(doc["traceFile"]) / 1e6}
    if sent[0] == 0 or (cuda and not any(named.values())):
        raise AssertionError(f"http: the trace names no Count kernel: {out['pprof_trace']}")
    status, prof = _cq_req(port, "GET", "/debug/pprof/profile?seconds=0.5&hz=200")
    status2, dump = _cq_req(port, "GET", "/debug/pprof")
    if status != 200 or prof["samples"] <= 0 or status2 != 200 or dump["count"] < 1:
        raise AssertionError(f"http: /debug/pprof/profile {status} or /debug/pprof {status2}")
    _cq_req(port, "GET", "/debug/pprof/heap?reset=true")
    armed = _cq_req(port, "GET", "/debug/pprof/heap")[1]
    heap = _cq_req(port, "GET", "/debug/pprof/heap")[1]
    _cq_req(port, "GET", "/debug/pprof/heap?reset=true")
    if not (armed["tracing"] and heap.get("top")):
        raise AssertionError(f"http: /debug/pprof/heap {armed} {str(heap)[:200]}")
    out["pprof_profile"] = {"samples": prof["samples"], "distinct_stacks": prof["distinctStacks"],
                            "threads": dump["count"], "heap_traced_bytes": heap["tracedBytes"]}
    caches = _cq_req(port, "GET", "/debug/vars")[1]["engineCaches"]["caches"]
    if list(caches) != list(ENGINE_CACHES) or caches["stack"]["hits"] <= 0:
        raise AssertionError(f"http: /debug/vars engineCaches.caches {caches}")
    out["engine_caches"] = caches
    log(f"http: /recalculate-caches, /debug/pprof*, engineCaches: {json.dumps(out)}")
    return out


def cq_http(port, cols):
    """Continuous queries over HTTP on the in-process node (the memo on):
    POST /cq of a Count tree and of a Row; a Set over HTTP, then GET
    /cq/{id}?since=1&wait_ms=5000 returns the new count, equal to a fresh
    query and served by the repair layer (resultRepair in /debug/vars);
    the Row's subscription ships a one-id diff after a one-bit Set;
    DELETE, then GET, is a 404.  Returns its numbers."""
    out = {}
    text = "Count(Intersect(Row(f=1), Row(f=2)))"
    n0 = int(np.intersect1d(cols[1], cols[2]).size)
    st, doc = _cq_req(port, "POST", "/cq", json.dumps({"index": CQ_INDEX, "query": text}))
    if st != 200 or doc.get("seq") != 1 or doc.get("result") != [n0]:
        raise AssertionError(f"cq: POST /cq {text}: {st} {doc} (numpy {n0})")
    cid = doc["id"]

    def repaired():
        return _cq_req(port, "GET", "/debug/vars")[1]["engineCaches"]["resultRepair"]

    rep0 = repaired()["repaired"]["count"]
    col = int(np.setdiff1d(cols[1], cols[2])[0])
    _cq_req(port, "POST", f"/index/{CQ_INDEX}/query", f"Set({col}, f=2)")
    t0 = time.perf_counter()
    st, got = _cq_req(port, "GET", f"/cq/{cid}?since=1&wait_ms={CQ_WAIT_MS}")
    out["count_delta_ms"] = (time.perf_counter() - t0) * 1e3
    fresh = _cq_req(port, "POST", f"/index/{CQ_INDEX}/query", text)[1]["results"]
    rep = repaired()
    if st != 200 or got.get("deltas") != [{"seq": 2, "result": [n0 + 1]}] or fresh != [n0 + 1]:
        raise AssertionError(f"cq: GET /cq/{cid} after Set({col}, f=2): {st} {got}; "
                             f"fresh {fresh}, want {n0 + 1}")
    if rep["repaired"]["count"] <= rep0:
        raise AssertionError(f"cq: the count's delta was not served by a repair: {rep}")
    out["count"] = {"before": n0, "after": fresh[0], "repairs": rep["repaired"]["count"] - rep0}
    st, doc = _cq_req(port, "POST", "/cq", json.dumps({"index": CQ_INDEX, "query": "Row(f=3)"}))
    if st != 200 or doc["result"][0]["columns"] != cols[3].tolist():
        raise AssertionError(f"cq: POST /cq Row(f=3): {st}")
    rid = doc["id"]
    col3 = int(np.setdiff1d(np.arange(1 << 20), cols[3])[0])
    _cq_req(port, "POST", f"/index/{CQ_INDEX}/query", f"Set({col3}, f=3)")
    t0 = time.perf_counter()
    st, got = _cq_req(port, "GET", f"/cq/{rid}?since=1&wait_ms={CQ_WAIT_MS}")
    out["row_diff_ms"] = (time.perf_counter() - t0) * 1e3
    if st != 200 or got.get("deltas") != [{"seq": 2, "diff": [{"added": [col3], "removed": []}]}]:
        raise AssertionError(f"cq: GET /cq/{rid} after Set({col3}, f=3): {st} {got}")
    cols[2] = np.union1d(cols[2], [col])
    cols[3] = np.union1d(cols[3], [col3])
    for qid in (cid, rid):
        if _cq_req(port, "DELETE", f"/cq/{qid}") != (200, {"deleted": qid}):
            raise AssertionError(f"cq: DELETE /cq/{qid}")
        st, _ = _cq_req(port, "GET", f"/cq/{qid}?since=0")
        if st != 404:
            raise AssertionError(f"cq: GET /cq/{qid} after DELETE: {st}")
    log(f"http: continuous queries: Count delta after a Set in {out['count_delta_ms']:.3f} ms "
        f"({out['count']}), the Row's one-id diff in {out['row_diff_ms']:.3f} ms, 404 after "
        "DELETE")
    return out


def cq_through_workers(srv, port, cols):
    """Continuous queries through a node with worker processes: create,
    long-poll and delete, a /cq request taken by a worker reaching the
    device owner as a passthrough frame (counted on the owner), and a
    Count answered while a poll waits.  Returns its numbers."""
    passed = [0]
    real = srv._handle_http

    def counting(conn, doc):
        if doc["target"].startswith("/cq"):
            passed[0] += 1
        return real(conn, doc)

    srv._handle_http = counting
    try:
        text = "Count(Union(Row(f=1), Row(f=3)))"
        n0 = int(np.union1d(cols[1], cols[3]).size)
        st, doc = _cq_req(port, "POST", "/cq", json.dumps({"index": CQ_INDEX, "query": text}))
        if st != 200 or doc.get("result") != [n0]:
            raise AssertionError(f"procmode: POST /cq {text}: {st} {doc} (numpy {n0})")
        cid = doc["id"]
        for _ in range(60):  # fresh connections until a worker took one
            if _cq_req(port, "GET", f"/cq/{cid}?since=1")[0] != 200:
                raise AssertionError(f"procmode: GET /cq/{cid}")
            if passed[0]:
                break
        if not passed[0]:
            raise AssertionError("procmode: no /cq request reached the owner through a worker")
        polled = {}

        def poll():
            polled["r"] = _cq_req(port, "GET", f"/cq/{cid}?since=1&wait_ms={CQ_WAIT_MS}")

        t = threading.Thread(target=poll)
        t.start()
        time.sleep(0.2)
        lat = []
        for _ in range(8):
            t0 = time.perf_counter()
            st, doc = _cq_req(port, "POST", f"/index/{CQ_INDEX}/query", text)
            lat.append((time.perf_counter() - t0) * 1e3)
            if st != 200 or doc["results"] != [n0]:
                raise AssertionError(f"procmode: a Count while a poll waits: {st} {doc}")
        if not t.is_alive():
            raise AssertionError(f"procmode: the poll returned before a write: {polled}")
        col = int(np.setdiff1d(np.arange(1 << 20), np.union1d(cols[1], cols[3]))[0])
        _cq_req(port, "POST", f"/index/{CQ_INDEX}/query", f"Set({col}, f=3)")
        t.join(CQ_WAIT_MS / 1e3 + 30)
        st, got = polled.get("r", (None, None))
        if t.is_alive() or st != 200 or got["deltas"] != [{"seq": 2, "result": [n0 + 1]}]:
            raise AssertionError(f"procmode: GET /cq/{cid} after Set({col}, f=3): {polled}")
        cols[3] = np.union1d(cols[3], [col])
        if _cq_req(port, "DELETE", f"/cq/{cid}") != (200, {"deleted": cid}):
            raise AssertionError(f"procmode: DELETE /cq/{cid}")
        if _cq_req(port, "GET", f"/cq/{cid}?since=0")[0] != 404:
            raise AssertionError(f"procmode: GET /cq/{cid} after DELETE")
    finally:
        srv._handle_http = real
    out = {"passthrough_frames": passed[0], "count_while_polling_p50_ms": statistics.median(lat)}
    log(f"procmode: continuous queries through 2 workers: {json.dumps(out)}; the delta after "
        "a Set exact, 404 after DELETE")
    return out


def run_http_path(device, holder, engine, host, seed, node_cmd=None,
                  node_shards=NODE_SHARDS, conns=QPS_CONNS, per_conn=QPS_PER_CONN):
    """The http phase, after fusion and before the writes of phase 5:
    pilosa_tpu_torch.net.server.serve over the north-star index and b10m
    (with bench.py's v10), as bench.py:806-824 serves them.  Over HTTP,
    every answer against numpy: Count(Intersect) on f (K1) and s (K2), an
    8-Count query (K5), a TopN (K3), Sum(field=v10) (K6), a GroupBy (K8),
    a protobuf query and a protobuf import, and an import-roaring into f
    synced in place; the launch counters are zeroed first and each must
    move.  Then bench.py's loops with the memo off, every reply checked:
    http_count_e2e_p50, http_count_qps (640 connections x 32 after the
    warm of tiers 1, 9, 65 and 257) and http_mixed_qps, then the debug
    routes (``debug_routes_http``); the same p50 on
    the threaded backend; and the node through its entry point (``python
    -m pilosa_tpu_torch server``), restarted on its data directory.
    Returns the phase's numbers."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.net import proto
    from pilosa_tpu_torch.net.admission import AdmissionController
    from pilosa_tpu_torch.net.server import serve
    from pilosa_tpu_torch.parallel import kernels

    cuda = device.type == "cuda"
    t_phase = t0 = time.perf_counter()
    out = {"card": card_line()}
    n_shards = len(host["f"][10])
    shards10 = list(range(N_SHARDS_10M))

    # bench.py's v10 on b10m (bench.py:459-468): planes 0..7 random, the
    # not-null plane all ones.
    rng = np.random.default_rng(seed + 31)
    v10 = holder.index("b10m").create_field(
        "v10", FieldOptions(type="int", min=0, max=(1 << BSI_DEPTH) - 1))
    planes = {p: rng.integers(0, 1 << 64, (N_SHARDS_10M, W64), dtype=np.uint64)
              for p in range(BSI_DEPTH)}
    planes[BSI_DEPTH] = np.full((N_SHARDS_10M, W64), (1 << 64) - 1, dtype=np.uint64)
    for sh in range(N_SHARDS_10M):
        frag = v10.view_if_not_exists("bsig_v10").fragment_if_not_exists(sh)
        for p, words in planes.items():
            frag.load_row_words(p, words[sh])
        frag.cache.invalidate()
    sum_want = [{"value": sum((1 << p) * int(popcounts(planes[p]).sum())
                              for p in range(BSI_DEPTH)),
                 "count": N_SHARDS_10M << 20}]
    w10 = _frag_words(holder, "b10m", "f", "standard", F10_ROWS, N_SHARDS_10M)
    c2_texts, c2_wants = c2_queries(w10)
    top10 = TopNOracle(w10)
    mixed_texts, mixed_wants = [], []
    for k in range(len(F10_ROWS) // 4):
        a = 100 + 4 * k
        for j in (k, (k + 7) % len(c2_texts)):
            mixed_texts.append(c2_texts[j])
            mixed_wants.append(c2_wants[j])
        mixed_texts.append(f"TopN(f, Row(f={a}), n=5)")
        mixed_wants.append([[{"id": r, "count": c} for r, c in top10.fused(w10[a], 5)]])
        mixed_texts.append("Sum(field=v10)")
        mixed_wants.append(sum_want)
    gw = _frag_words(holder, "bench", "ga", "standard", range(G_ROWS["ga"]), n_shards)
    gb = _frag_words(holder, "bench", "gb", "standard", range(G_ROWS["gb"]), n_shards)
    group_want = []
    for a in range(G_ROWS["ga"]):
        for b in range(G_ROWS["gb"]):
            n = int(and_popcounts(gw[a], gb[b]).sum())
            if n:
                group_want.append({"group": [{"field": "ga", "rowID": a},
                                             {"field": "gb", "rowID": b}], "count": n})
    del gw, gb
    want = expected_counts(host)
    topn_want = [[{"id": r, "count": c}
                  for r, c in TopNOracle(host["top"]).fused(host["f"][10], 5)]]
    log(f"http: b10m's v10 made; numpy oracles in {time.perf_counter() - t0:.3f} s")

    cq_cols = build_cq_index(holder, seed)
    api = API(holder=holder, engine=engine)
    srv, _ = serve(api, "localhost", 0, admission=AdmissionController(max_inflight=1 << 17))
    port = srv.server_address[1]
    try:
        # -- every kernel of the path, through the routes ------------------
        fallbacks0 = api.executor.host_fallbacks
        with memo_off(engine):
            _zero_http_launches()
            for field in ("f", "s"):
                text = pql_of(field, "and", (10, 11))
                _http_results(port, "bench", text, [want[text]], text)
            texts8 = eight_counts("f")
            _http_results(port, "bench", texts8,
                          [want[pql_of("f", "and", (10 + 2 * k, 11 + 2 * k))] for k in range(8)],
                          "the 8-Count query")
            _http_results(port, "bench", "TopN(top, Row(f=10), n=5)", topn_want, "TopN")
            _http_results(port, "b10m", "Sum(field=v10)", sum_want, "Sum(field=v10)")
            _http_results(port, "bench", Q8, [group_want], Q8)
            # Protobuf: a query in and out, and an import.
            text = pql_of("f", "and", (12, 13))
            status, ctype, body = _http_post(
                port, "bench", proto.encode_query_request(text),
                {"Content-Type": proto.CONTENT_TYPE, "Accept": proto.CONTENT_TYPE})
            doc = proto.decode_query_response(body, device=device)
            if (status, ctype, doc["err"], doc["results"]) != (200, proto.CONTENT_TYPE, "",
                                                               [want[text]]):
                raise AssertionError(f"http: protobuf {text}: {status} {ctype} {doc}")
            launches = _http_launches()
        api.create_field("b10m", "pb")
        cols = np.unique(rng.integers(0, N_SHARDS_10M << 20, 5000)).tolist()
        import urllib.request

        req = urllib.request.Request(
            f"http://localhost:{port}/index/b10m/field/pb/import", method="POST",
            data=proto.encode_import_request("b10m", "pb", 0, row_ids=[1] * len(cols),
                                             column_ids=cols),
            headers={"Content-Type": proto.CONTENT_TYPE})
        with urllib.request.urlopen(req, timeout=120) as resp:
            if resp.status != 200:
                raise AssertionError(f"http: protobuf import: {resp.status}")
        _http_results(port, "b10m", "Count(Row(pb=1))", [len(cols)], "after a protobuf import")
        # import-roaring into f: half of one shard of row 33 set anew,
        # synced in place behind the import.
        sh = n_shards // 2
        new_cols = np.sort(rng.choice(1 << 20, 1 << 19, replace=False)).astype(np.uint64)
        upd0, reb0 = engine.stack_updates, engine.stack_rebuilds
        old = host["f"][33][sh].copy()
        t0 = time.perf_counter()
        from pilosa_tpu_torch.roaring import codec

        req = urllib.request.Request(
            f"http://localhost:{port}/index/bench/field/f/import-roaring/{sh}", method="POST",
            data=codec.serialize(np.uint64(33 << 20) + new_cols))
        with urllib.request.urlopen(req, timeout=300) as resp:
            changed = json.loads(resp.read())["changed"]
        engine.ingest_syncer().flush()
        roaring_s = time.perf_counter() - t0
        # The fragment keeps the oracle's array as the row's storage, or
        # replaced it: either way the oracle takes the fragment's words.
        host["f"][33][sh] = holder.fragment("bench", "f", "standard", sh).row_words(33).view(
            np.uint64)
        if changed != int(popcounts(host["f"][33][sh] & ~old)):
            raise AssertionError(f"http: import-roaring changed {changed}")
        text = pql_of("f", "and", (32, 33))
        with memo_off(engine):
            _http_results(port, "bench", text, [int(oracle(host["f"], "and", (32, 33)))],
                          text + " after import-roaring")
        out["import_roaring"] = {"changed": changed, "seconds": roaring_s,
                                 "stack_updates": engine.stack_updates - upd0,
                                 "stack_rebuilds": engine.stack_rebuilds - reb0}
        log(f"http: every answer exact over HTTP; launches {json.dumps(launches)}; "
            f"import-roaring {json.dumps(out['import_roaring'])}")
        out["launches"] = launches
        if cuda and min(launches[k] for k in ("count_tree_dense", "count_tree_blocks",
                                              "count_batch_tree", "score_rows", "sum_tree",
                                              "groupn_tree")) <= 0:
            raise AssertionError(f"http: a kernel of the path never launched: {launches}")
        if (out["import_roaring"]["stack_updates"], out["import_roaring"]["stack_rebuilds"]) \
                != (1, 0):
            raise AssertionError(f"http: import-roaring sync {out['import_roaring']}")
        # -- continuous queries (the memo on) --------------------------------
        out["cq"] = cq_http(port, cq_cols)
        api.cq.close()

        # -- bench.py's loops, the memo off ----------------------------------
        with memo_off(engine):
            out["http_count_e2e_p50"] = _seq_p50(port, c2_texts, c2_wants)
            warm = pql.parse(c2_texts[0]).calls[0].children[0]
            for k in WARM_TIERS:
                engine.count_many("b10m", [warm] * k, [shards10] * k)
            b = engine.batcher()
            b0, q0 = b.batches, b.batched_queries
            # The largest drain of this load alone: the gauge keeps a
            # high-water mark, so it starts from 0 here.
            b.pipeline.gauge("max_batch_occupancy", 0)
            _zero_http_launches()
            qps, n = run_qps(port, c2_texts, c2_wants, conns, per_conn)
            by_k = dict(kernels.count_batch_tree_cuda.by_k)
            batches, batched = b.batches - b0, b.batched_queries - q0
            out["http_count_qps"] = qps
            snap = engine.pipeline_snapshot() or {}
            out["count_qps_batches"] = {
                "requests": n, "batches": batches, "batched_queries": batched,
                "mean_batch": batched / max(1, batches),
                "max_batch": snap.get("gauges", {}).get("max_batch_occupancy"),
                "k5_launches": sum(by_k.values()),
                "k5_max_k": max(by_k, default=0),
                "k5_launches_k_ge_256": sum(v for k, v in by_k.items() if k >= 256),
                "k5_by_k": {str(k): by_k[k] for k in sorted(by_k)}}
            log(f"http: http_count_e2e_p50 {out['http_count_e2e_p50']:.4f} ms; http_count_qps "
                f"{qps:.1f} over {n} requests ({conns} connections x {per_conn}), every reply "
                f"exact; batches {json.dumps(out['count_qps_batches'])}")
            _zero_http_launches()
            for text, w in zip(mixed_texts[:8], mixed_wants[:8]):
                _http_results(port, "b10m", text, w, text)
            b0, q0 = b.batches, b.batched_queries
            mixed, n = run_qps(port, mixed_texts, mixed_wants, conns, per_conn)
            out["http_mixed_qps"] = mixed
            out["mixed_launches"] = _http_launches()
            out["mixed_batches"] = {"batches": b.batches - b0,
                                    "mean_batch": (b.batched_queries - q0)
                                    / max(1, b.batches - b0)}
            log(f"http: http_mixed_qps {mixed:.1f} over {n} requests, every reply exact; "
                f"batches {json.dumps(out['mixed_batches'])}; launches "
                f"{json.dumps(out['mixed_launches'])} (F1 counted, not required)")
        # After bench.py's timed loops, so that no profiler capture or
        # tracemalloc precedes them.
        out["debug_routes"] = debug_routes_http(port, engine, c2_texts, c2_wants, topn_want, cuda)
    finally:
        srv.shutdown()
    if api.executor.host_fallbacks != fallbacks0:
        raise AssertionError("http: a query fell back to the host lane")

    # -- the threaded backend (the reference's differential oracle) ---------
    srv, _ = serve(api, "localhost", 0, backend="threaded")
    try:
        with memo_off(engine):
            out["http_count_e2e_p50_threaded"] = _seq_p50(srv.server_address[1], c2_texts,
                                                          c2_wants)
    finally:
        srv.shutdown()
        srv.server_close()
    log(f"http: http_count_e2e_p50 on the threaded backend "
        f"{out['http_count_e2e_p50_threaded']:.4f} ms")
    # The layers under HTTP: the same Counts through API.query (the sync
    # path: the engine's Count, no batcher) and API.query_async (the
    # batcher, as the reactor submits them), each answer checked.
    from pilosa_tpu_torch.api import QueryRequest

    for name, run in (("api_query_p50", lambda t: api.query(QueryRequest("b10m", t))),
                      ("api_query_async_p50",
                       lambda t: api.query_async(QueryRequest("b10m", t)).result(300))):
        lat = []
        with memo_off(engine):
            for i in range(HTTP_REPS):
                k = i % len(c2_texts)
                t0 = time.perf_counter()
                got = run(c2_texts[k]).results
                lat.append((time.perf_counter() - t0) * 1e3)
                if got != c2_wants[k]:
                    raise AssertionError(f"http: {name} {c2_texts[k]}: {got} != {c2_wants[k]}")
        out[name] = statistics.median(lat)
    log(f"http: the same Counts through API.query p50 {out['api_query_p50']:.4f} ms, "
        f"API.query_async p50 {out['api_query_async_p50']:.4f} ms")

    # -- the node through its entry point -----------------------------------
    out["node"] = run_http_node(w10, c2_texts, c2_wants, node_cmd, node_shards)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"http: phase {out['seconds']:.3f} s; {out['card']}")
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_node(cmd, data_dir, port, log_path, extra=()):
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    errf = open(log_path, "ab")
    proc = subprocess.Popen(cmd + ["server", "-d", data_dir, "-b", f"localhost:{port}"]
                            + list(extra),
                            cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=errf)
    errf.close()
    return proc


def _wait_ready(proc, port, log_path, what, timeout=None):
    """Poll /readyz until 200 (at most NODE_READY_S from the start); a
    node still opening its holder has bound its socket but serves nothing
    yet, so each poll has a short timeout.  Returns (seconds, whether a
    503 'warming' answer was seen)."""
    from pilosa_tpu_torch.net import InternalClient
    from pilosa_tpu_torch.net.client import ClientError

    client = InternalClient(f"http://localhost:{port}", timeout=2.0, retries=0)
    timeout = NODE_READY_S if timeout is None else timeout
    t0 = time.perf_counter()
    warming = False
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(f"http: the node exited ({proc.returncode}) {what}: "
                                 f"{open(log_path).read()[-3000:]}")
        try:
            client._get("/readyz")
            return time.perf_counter() - t0, warming
        except ClientError as e:
            if e.code == 503 and "warming" in (e.body or ""):
                warming = True
        time.sleep(0.1)
    raise AssertionError(f"http: /readyz not 200 within {timeout} s {what}")


def _stop_node(proc, log_path):
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("http: the node did not stop on SIGTERM within 60 s")
    text = open(log_path).read()
    if rc != 0 or "Traceback" in text:
        raise AssertionError(f"http: the node exited {rc}: {text[-3000:]}")
    return text


def run_http_node(w10, c2_texts, c2_wants, node_cmd=None, node_shards=NODE_SHARDS):
    """``python -m pilosa_tpu_torch server`` as a subprocess on a data
    directory under build/: b10m's schema through InternalClient, its 128
    rows over ``node_shards`` shards through import-roaring, the c2 Counts
    against numpy, ``export`` and ``backup`` of a small index through the
    CLI, then SIGTERM, a restart on the same directory whose warm start
    must build every stack and skip none before /readyz answers 200, and
    the same Counts again.  ``node_cmd`` replaces ``python -m
    pilosa_tpu_torch`` (a CPU rehearsal)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.net import InternalClient

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "http_node")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_dir, log_path = os.path.join(work, "data"), os.path.join(work, "node.log")
    cmd = node_cmd or [sys.executable, "-m", "pilosa_tpu_torch"]
    port = _free_port()
    out = {}
    # The oracle over the node's shards.
    wn = {r: w[:node_shards] for r, w in w10.items()}
    _, wants = c2_queries(wn)
    t0 = time.perf_counter()
    proc = _start_node(cmd, data_dir, port, log_path)
    try:
        client = InternalClient(f"http://localhost:{port}", timeout=600)
        out["start_s"], _ = _wait_ready(proc, port, log_path, "at its first start")
        # No existence field: bench.py loads b10m's rows with no existence
        # bits either, and 2^20 columns of existence per shard would
        # double the import's host work.
        client._post("/index/b10m", {"options": {"trackExistence": False}})
        client.create_field("b10m", "f")
        t1 = time.perf_counter()
        bodies = [dense_roaring({r: wn[r][sh] for r in F10_ROWS}) for sh in range(node_shards)]

        def imp(sh):
            return client.import_roaring("b10m", "f", sh, bodies[sh])

        with ThreadPoolExecutor(node_shards) as pool:
            changed = list(pool.map(imp, range(node_shards)))
        want_bits = [int(sum(popcounts(wn[r][sh]) for r in F10_ROWS)) for sh in
                     range(node_shards)]
        if changed != want_bits:
            raise AssertionError(f"http: node import-roaring changed {changed} != {want_bits}")
        out["import_s"] = time.perf_counter() - t1
        out["import_bytes"] = sum(len(b) for b in bodies)
        del bodies

        def counts(c):
            for text, w in zip(c2_texts, wants):
                doc = c.query("b10m", text)
                if doc["results"] != w or "traceID" not in doc:
                    raise AssertionError(f"http: node {text}: {doc} != {w}")

        counts(client)
        # A small index for the CLI's export and backup.
        client.create_index("tiny")
        client.create_field("tiny", "f")
        client.query("tiny", "Set(1, f=10) Set(1048580, f=10) Set(2, f=11)")
        host_arg = ["--host", f"http://localhost:{port}"]
        env = dict(os.environ, PYTHONPATH=root)
        res = subprocess.run(cmd + ["export"] + host_arg + ["-i", "tiny", "-f", "f"], cwd=root,
                             env=env, capture_output=True, text=True, timeout=120)
        if res.returncode != 0 or sorted(res.stdout.split()) != ["10,1", "10,1048580", "11,2"]:
            raise AssertionError(f"http: export: {res.returncode} {res.stdout!r} {res.stderr}")
        archive = os.path.join(work, "tiny.tar.gz")
        res = subprocess.run(cmd + ["backup"] + host_arg + ["-i", "tiny", "-o", archive],
                             cwd=root, env=env, capture_output=True, text=True, timeout=120)
        if res.returncode != 0 or not os.path.getsize(archive):
            raise AssertionError(f"http: backup: {res.returncode} {res.stderr}")
        out["backup"] = res.stdout.strip()
        metrics = client._get("/metrics", raw=True).decode()
        if "pilosa_server_requests_total" not in metrics:
            raise AssertionError("http: /metrics lacks pilosa_server_requests_total")
        first_log = _stop_node(proc, log_path)
        # The restart: the warm start builds every stack before /readyz is 200.
        t1 = time.perf_counter()
        proc = _start_node(cmd, data_dir, port, log_path)
        client = InternalClient(f"http://localhost:{port}", timeout=600)
        out["restart_ready_s"], out["warming_seen"] = _wait_ready(proc, port, log_path,
                                                                  "after its restart")
        line = None
        for _ in range(50):
            text = open(log_path).read()[len(first_log):]
            line = next((ln for ln in text.splitlines() if "warm-start done" in ln), None)
            if line is not None:
                break
            time.sleep(0.1)
        import re

        m = re.search(r"warm-start done: (\d+)/(\d+) stacks resident \((\d+) skipped\)",
                      line or "")
        if m is None or m.group(1) != m.group(2) or m.group(3) != "0" or int(m.group(2)) < 2:
            raise AssertionError(f"http: the restart's warm start: {line!r}")
        out["warm_start"] = line.split("warm-start done: ")[1]
        ready = client.readiness()
        if not ready["ready"] or not ready["warming"]["done"]:
            raise AssertionError(f"http: /readyz after the warm start: {ready}")
        counts(client)
        _stop_node(proc, log_path)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["seconds"] = time.perf_counter() - t0
    log(f"http: the node (python -m pilosa_tpu_torch server, {node_shards} shards x "
        f"{len(F10_ROWS)} rows, {out['import_bytes'] / 1e6:.1f} MB by import-roaring in "
        f"{out['import_s']:.3f} s) answered the 32 c2 Counts exactly, before and after a "
        f"SIGTERM and restart (warm start {out['warm_start']}; /readyz 200 after "
        f"{out['restart_ready_s']:.3f} s, warming seen {out['warming_seen']}); export and "
        f"backup ran; {out['seconds']:.3f} s")
    return out


# -- the procmode phase: process mode and the query plans --------------------

PM_WORKERS = (0, 1, 2, 4, 8)  # bench.py's workers sweep (bench.py:1228-1275)
PM_CONNS, PM_TOTAL = 128, 8192  # bench.py W_CONNS, W_TOTAL
PM_TENANT = "procmode"
OVH_SHARDS = 8  # bench.py OVH_SHARDS
OVH_P50_REPS = 48  # bench.py OVH_P50_REPS: the real query's wall p50
OVH_REPLAY_N = 20000  # bench.py OVH_REPLAY_N: replays of the plan sequence
OVH_REPLAY_LOOPS = 8  # bench.py OVH_REPLAY_LOOPS: the best mean over this many loops


def _compute_app_pids():
    """The pids ``nvidia-smi --query-compute-apps=pid`` lists: the
    processes holding a CUDA context on the card."""
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True)
    return sorted(int(x) for x in res.stdout.split() if x.strip().isdigit())


def _nvidia_fds(pid):
    """How many of process ``pid``'s open files are the card's device
    nodes (/dev/nvidia*): a CUDA context holds them open, and a process
    that never made one (importing torch maps libcuda but opens none)
    holds none."""
    n = 0
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
        except OSError:
            pass  # closed while listed
    return n


def _worker_inline(srv):
    """{worker: requests its reactor answered inline} from each worker's
    registry, fetched over the engine link (a /metrics aggregation)."""
    srv.aggregate_metrics(srv.handler)
    out = {}
    for wid in range(srv.workers):
        text = srv._last_stats.get(wid, {}).get("text", "")
        out[wid] = sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                       if ln.startswith('pilosa_server_requests_total{path="inline"}'))
    return out


def _engine_sparse_blocks(engine, index, text, shards):
    """(blocks surviving, blocks total) of the engine's own sparse plan
    (``_sparse_plan``) for a Count's tree over ``shards``."""
    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.ops import bitops
    from pilosa_tpu_torch.parallel.engine import _Lowering
    from pilosa_tpu_torch.util import plans

    call = pql.parse(text).calls[0].children[0]
    canonical = engine.canonical_shards(index)
    with engine._stacks_lock:
        lw = _Lowering(engine, canonical)
        prog = engine._lower(index, call, lw)
        plan = engine._sparse_plan(prog, lw, shards, canonical)
    plans.take_dispatch_note()  # the planner's note: no plan on this thread
    if plan is None:
        raise AssertionError(f"procmode: {text} takes no sparse plan")
    return bitops.popcount_np(plan[0].view(np.uint64)), len(shards) * bitops.OCC_BLOCKS


def _profiled_through_a_worker(srv, port, text, tries=40):
    """POST ``text`` with ?profile=1 and the tenant header on fresh
    connections until a worker process (not the owner's own reactor, the
    third member of the accept group) answered one; its decoded reply."""
    for _ in range(tries):
        before = _worker_inline(srv)
        status, _, body = _http_post(port, "bench", text, {"X-Pilosa-Tenant": PM_TENANT},
                                     path_suffix="?profile=1")
        if status != 200:
            raise AssertionError(f"procmode: ?profile=1 {text}: {status} {body[:200]!r}")
        after = _worker_inline(srv)
        if any(after[w] > before[w] for w in after):
            return json.loads(body)
    raise AssertionError(f"procmode: no worker answered {text} in {tries} tries")


def profile_overhead(device, seed):
    """bench.py's profile_overhead_pct estimator (bench.py:3097-3212) on
    the port: the denominator is the wall p50 of the real
    Count(Intersect(Row(f=0), Row(f=1))) over an 8-shard index through
    API.query with plans on, on a holder and engine of its own as
    bench.py builds them; the numerator replays the record sequence that
    query's plan holds (begin and attach, its dispatch notes, the op,
    stage and device stamps, finish, ring and ledger), the best mean over
    several loops."""
    from pilosa_tpu_torch.api import API, QueryRequest
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.parallel.engine import TorchEngine
    from pilosa_tpu_torch.util import plans

    rng = np.random.default_rng(seed + 11)  # bench.py's rng(11), offset by the seed
    holder = Holder(device=device)
    holder.open()
    engine = TorchEngine(holder, device=device)
    f = holder.create_index("ovh").create_field("f")
    view = f.view_if_not_exists("standard")
    for s in range(OVH_SHARDS):
        frag = view.fragment_if_not_exists(s)
        for r in (0, 1):
            frag.load_row_words(r, rng.integers(0, 1 << 64, W64, dtype=np.uint64))
    for frag in view.fragments.values():
        frag.cache.invalidate()
    api = API(holder=holder, engine=engine)
    req = QueryRequest("ovh", "Count(Intersect(Row(f=0), Row(f=1)))")
    want = int(popcounts(np.stack([
        holder.fragment("ovh", "f", "standard", s).row_words(0).view(np.uint64)
        & holder.fragment("ovh", "f", "standard", s).row_words(1).view(np.uint64)
        for s in range(OVH_SHARDS)])).sum())
    with memo_off(engine):
        for _ in range(3):
            if int(api.query(req).results[0]) != want:
                raise AssertionError("procmode: the overhead query disagrees with numpy")
        lat = []
        for _ in range(OVH_P50_REPS):
            t0 = time.perf_counter()
            resp = api.query(req)
            lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat)
    real = plans.STORE.find(resp.trace_id)
    if real is None:
        raise AssertionError("procmode: the overhead query's plan was not recorded")
    op_fields = dict(real.ops[0]) if real.ops else {"op": "Count", "path": "direct"}
    occ = {k: op_fields.pop(k) for k in ("blocks_surviving", "blocks_total", "occ_fraction",
                                         "threshold") if k in op_fields}
    stage_events = list(real._stage_events)
    dur = real.duration or p50
    trace_id = resp.trace_id or "procmode"

    def replay():
        p = plans.begin("ovh", req.query)
        with plans.attach(p):
            if occ:
                plans.note_dispatch(**occ)
            plans.note_dispatch(**op_fields)
            note = plans.take_dispatch_note()
            p.note_op(**note)
            for st, s in stage_events:
                p.note_stage(st, s)
            p.finish(dur, trace_id=trace_id)
        plans.record(p)

    for _ in range(OVH_REPLAY_N // 10):
        replay()
    loop_n = max(1, OVH_REPLAY_N // OVH_REPLAY_LOOPS)
    best = math.inf
    for _ in range(OVH_REPLAY_LOOPS):
        t0 = time.perf_counter()
        for _ in range(loop_n):
            replay()
        best = min(best, (time.perf_counter() - t0) / loop_n)
    engine.close()
    return {"count_intersect_plans_on_p50_ms": p50 * 1e3, "plan_record_us": best * 1e6,
            "profile_overhead_pct": best / p50 * 100.0, "plan_ops": real.to_dict()["ops"]}


def run_procmode_path(device, holder, engine, host, seed, node_cmd=None, workers=PM_WORKERS,
                      conns=PM_CONNS, total=PM_TOTAL, node_shards=NODE_SHARDS):
    """The procmode phase, after http and before residency: process mode
    and the query plans over the same in-process API, ``bench`` (960
    shards) and ``b10m``, the memo off as in the http phase.

    bench.py's workers sweep: ``serve(api, workers=w)`` for w in 0, 1, 2,
    4 and 8, each reply of 128 connections x 64 c2 Counts 200 and exact,
    ``http_count_qps_w{w}`` with the batch occupancy and
    ``cross_worker_fused_batches`` (> 0 at w >= 2), the worker boot to
    HELLO and the w2/w0 ratio.  With four workers, no worker holds a CUDA
    context (``nvidia-smi --query-compute-apps`` lists what it listed with
    the owner alone and no worker pid, and no worker has a /dev/nvidia*
    node open) while the owner does.  With two: a
    sparse Count with ?profile=1 and X-Pilosa-Tenant answered by a worker
    process: exact, its plan ``path: sparse`` with the engine's
    ``_sparse_plan`` block counts, K2 in the profiler's window and its
    counter, the plan in /debug/plans under its trace id, and
    /debug/sequences answering; then ``Explain(Count(...))`` returns the
    plan with no kernel in the profiler's window and no counter moved.
    bench.py's profile_overhead_pct.  Then the node: ``python -m
    pilosa_tpu_torch server`` with ``[server] workers = 2`` on the http
    phase's data directory (restart to ready), a SIGKILL of a worker
    (/readyz 503, then 200 after the respawn) and every answer exact
    before and after.  Returns the phase's numbers and its launches."""
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.net.admission import AdmissionController
    from pilosa_tpu_torch.net.server import serve
    from pilosa_tpu_torch.util import plans

    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    out = {"card": card_line()}
    w10 = _frag_words(holder, "b10m", "f", "standard", F10_ROWS, N_SHARDS_10M)
    texts, wants = c2_queries(w10)
    mixed_texts, mixed_wants = http_mixed(holder, w10)
    want = expected_counts(host)
    api = API(holder=holder, engine=engine)
    plans.STORE.reset()
    plans.LEDGER.reset()
    sweep, boot = {}, {}
    # The card's compute apps with the owner alone (its pid as the chip
    # machine's nvidia-smi sees it may not be this namespace's).
    apps0 = _compute_app_pids() if cuda else []
    _zero_http_launches()
    zero_counts()
    with memo_off(engine):
        for w in workers:
            t0 = time.perf_counter()
            srv, _ = serve(api, "localhost", 0, workers=w,
                           admission=AdmissionController(max_inflight=1 << 17))
            try:
                if w and not srv.wait_ready(120):
                    raise AssertionError(f"procmode: {w} workers never connected")
                if w:
                    boot[w] = time.perf_counter() - t0
                port = srv.server_address[1]
                run_qps(port, texts, wants, 8, 32)  # warm connections and worker boots
                b = engine.batcher()
                b0, q0 = b.batches, b.batched_queries
                x0 = b.pipeline.snapshot()["counters"].get("cross_worker_fused_batches", 0)
                qps, n = run_qps(port, texts, wants, conns, max(32, total // conns))
                xw = b.pipeline.snapshot()["counters"].get("cross_worker_fused_batches", 0) - x0
                occ = (b.batched_queries - q0) / max(1, b.batches - b0)
                out[f"http_count_qps_w{w}"] = qps
                sweep[w] = {"requests": n, "batches": b.batches - b0, "occupancy": occ,
                            "cross_worker_fused_batches": xw}
                log(f"procmode: workers sweep w{w}: {qps:.1f} qps over {n}, every reply exact; "
                    f"occupancy {occ:.2f}, cross-worker fused batches {xw}"
                    + (f"; boot to HELLO {boot[w]:.3f} s" if w else ""))
                if w >= 2 and xw <= 0:
                    raise AssertionError(f"procmode: w{w}: no batch spanned two workers")
                if w == 4 and cuda:
                    pids = list(srv.worker_pids().values())
                    apps = _compute_app_pids()
                    owner = os.getpid()
                    held = {"owner": owner, "workers": pids, "compute_apps_owner_alone": apps0,
                            "compute_apps": apps, "owner_nvidia_fds": _nvidia_fds(owner),
                            "worker_nvidia_fds": [_nvidia_fds(p) for p in pids]}
                    out["cuda_contexts"] = held
                    log(f"procmode: CUDA contexts with 4 workers: {json.dumps(held)}")
                    # With four workers up, the card lists the contexts it
                    # listed with the owner alone, and no worker's pid; no
                    # worker has a device node open, the owner has.
                    if (len(pids) != 4 or set(pids) & set(apps) or apps != apps0
                            or any(held["worker_nvidia_fds"]) or not held["owner_nvidia_fds"]):
                        raise AssertionError(f"procmode: a worker holds a CUDA context: {held}")
                if w == 2:
                    out["cq"] = cq_through_workers(srv, port, cq_cols_of(holder))
                    out.update(_plans_through_workers(srv, port, engine, want, cuda))
                    out["mixed_w2"] = _mixed_through_workers(engine, port, mixed_texts,
                                                             mixed_wants, conns, cuda)
            finally:
                srv.shutdown()
                srv.server_close()
    out["launches"] = read_counts()
    out["sweep"] = sweep
    out["worker_boot_s"] = boot
    if out.get("http_count_qps_w0"):
        out["w2_over_w0"] = out["http_count_qps_w2"] / out["http_count_qps_w0"]
    log(f"procmode: w2/w0 {out.get('w2_over_w0', 0):.3f}; launches {json.dumps(out['launches'])}")
    if cuda and min(out["launches"][k] for k in ("count_tree_dense", "count_tree_blocks")) <= 0:
        raise AssertionError(f"procmode: a kernel of the path never launched: {out['launches']}")
    out["tenants"] = plans.LEDGER.snapshot().get(PM_TENANT)
    ovh = profile_overhead(device, seed)
    out.update({k: v for k, v in ovh.items() if k != "plan_ops"})
    log(f"procmode: plan-recording overhead: record {ovh['plan_record_us']:.3f} us / query "
        f"p50 {ovh['count_intersect_plans_on_p50_ms'] * 1e3:.1f} us = "
        f"{ovh['profile_overhead_pct']:.4f}% (target < 2%); its plan's ops "
        f"{json.dumps(ovh['plan_ops'])}")
    out["node"] = run_procmode_node(w10, texts, node_cmd, node_shards)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"procmode: phase {out['seconds']:.3f} s; {out['card']}")
    return out


def http_mixed(holder, w10):
    """The http phase's mixed dashboard on b10m (bench.py's http_mixed:
    per four-row tree two c2 Counts, a TopN and Sum(field=v10)) and its
    numpy answers, from the words the fragments hold: v10 is the one the
    http phase made."""
    planes = _frag_words(holder, "b10m", "v10", "bsig_v10", range(BSI_DEPTH), N_SHARDS_10M)
    sum_want = [{"value": sum((1 << p) * int(popcounts(w).sum()) for p, w in planes.items()),
                 "count": N_SHARDS_10M << 20}]
    c2_texts, c2_wants = c2_queries(w10)
    top10 = TopNOracle(w10)
    texts, wants = [], []
    for k in range(len(F10_ROWS) // 4):
        a = 100 + 4 * k
        for j in (k, (k + 7) % len(c2_texts)):
            texts.append(c2_texts[j])
            wants.append(c2_wants[j])
        texts.append(f"TopN(f, Row(f={a}), n=5)")
        wants.append([[{"id": r, "count": c} for r, c in top10.fused(w10[a], 5)]])
        texts.append("Sum(field=v10)")
        wants.append(sum_want)
    return texts, wants


def _mixed_through_workers(engine, port, texts, wants, conns, cuda):
    """With two workers: the mixed dashboard from ``conns`` connections of
    32 queries each, every reply 200 and exact; the TopN and Sum results
    come back through the worker's encode, and the drains that hold them
    with Counts run fused (F1 with its K3 and K6 edges) on the card."""
    pipe = engine.batcher().pipeline
    before, fused0 = _http_launches(), pipe.snapshot()["counters"].get("fused_program_batches", 0)
    qps, n = run_qps(port, texts, wants, conns, 32)
    moved = {k: v - before[k] for k, v in _http_launches().items() if v != before[k]}
    fused = pipe.snapshot()["counters"].get("fused_program_batches", 0) - fused0
    log(f"procmode: mixed dashboard through 2 workers: {qps:.1f} qps over {n}, every reply "
        f"exact; fused drains {fused}; launches {json.dumps(moved)}")
    if fused <= 0 or (cuda and moved.get("fused_tree", 0) <= 0):
        raise AssertionError(f"procmode: the mixed load ran no fused drain: {fused}, {moved}")
    return {"http_mixed_qps": qps, "requests": n, "fused_drains": fused, "launches": moved}


def _plans_through_workers(srv, port, engine, want, cuda):
    """With two workers: the sparse Count's plan through a worker, the
    plan routes, and Explain (run_procmode_path's docstring)."""
    from pilosa_tpu_torch.parallel import sparse

    out = {}
    text = pql_of("s", "and", (10, 11))
    shards = engine.canonical_shards("bench")
    got = {}

    def ask():
        k2 = sparse.count_tree_blocks_cuda.launches
        got["doc"] = _profiled_through_a_worker(srv, port, text)
        got["k2"] = sparse.count_tree_blocks_cuda.launches - k2

    seen = on_card(ask, lambda s: any("count_tree_blocks" in k for k in s)) if cuda else ask()
    doc = got["doc"]
    plan = doc["plan"]
    op = next(o for o in plan["ops"] if o.get("op") == "Count")
    surviving, total = _engine_sparse_blocks(engine, "bench", text, shards)
    out["sparse_plan"] = {"results": doc["results"], "path": op["path"],
                          "blocks_surviving": op["blocks_surviving"],
                          "blocks_total": op["blocks_total"], "engine": [surviving, total],
                          "tenant": plan["tenant"], "k2_launches": got["k2"],
                          "bytes_skipped": plan["bytesSkipped"],
                          "annotations": plan["annotations"]}
    log(f"procmode: ?profile=1 {text} through a worker: {json.dumps(out['sparse_plan'])}"
        + (f"; on the card {json.dumps(per_launch(seen))}" if cuda else ""))
    if (doc["results"] != [want[text]] or op["path"] != "sparse"
            or (op["blocks_surviving"], op["blocks_total"]) != (surviving, total)
            or plan["tenant"] != PM_TENANT or plan["traceID"] != doc["traceID"]
            or (cuda and got["k2"] <= 0)):
        raise AssertionError(f"procmode: the sparse Count's plan: {out['sparse_plan']}")
    from pilosa_tpu_torch.net import InternalClient

    client = InternalClient(f"http://localhost:{port}", timeout=60)
    found = client._get(f"/debug/plans?trace={doc['traceID']}")["plans"]
    if len(found) != 1 or found[0]["ops"] != plan["ops"]:
        raise AssertionError(f"procmode: /debug/plans?trace= holds {found}")
    seq = client._get("/debug/sequences")
    if seq.get("observed", 0) < 1:
        raise AssertionError(f"procmode: /debug/sequences: {seq}")
    out["sequences"] = {k: seq[k] for k in ("observed", "edgesObserved", "signatures")}
    # Explain: the plan, with nothing launched.
    explain = f"Explain({text})"
    before = _http_launches()

    def dry():
        got["explain"] = _http_results(port, "bench", explain, None, explain)

    if cuda:
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dry()
            torch.cuda.synchronize()
        kernels_seen = sorted({e.key for e in prof.key_averages()
                               if e.device_type == torch.autograd.DeviceType.CUDA})
    else:
        dry()
        kernels_seen = []
    moved = {k: v - before[k] for k, v in _http_launches().items() if v != before[k]}
    ex = got["explain"]["results"][0]
    out["explain"] = {"plannedPath": ex.get("plannedPath"),
                      "blocksSurviving": ex.get("blocksSurviving"), "kernels": kernels_seen,
                      "launches_moved": moved}
    log(f"procmode: {explain}: {json.dumps(ex)}; kernels while it ran {kernels_seen}, "
        f"launches moved {moved}")
    if (ex.get("plannedPath") != "sparse" or ex.get("blocksSurviving") != surviving
            or kernels_seen or moved):
        raise AssertionError(f"procmode: Explain: {out['explain']}")
    return out


def run_procmode_node(w10, c2_texts, node_cmd=None, node_shards=NODE_SHARDS):
    """``python -m pilosa_tpu_torch server -c <[server] workers = 2>`` on
    the http phase's data directory (build/http_node/data): restart to
    ready (the warm start and both workers' HELLO), the c2 Counts exact,
    a SIGKILL of one worker, /readyz 503 and then 200 after the
    supervisor's respawn, every Count answered in between exact or shed,
    and the Counts exact again; SIGTERM, exit 0, no traceback."""
    import signal

    from pilosa_tpu_torch.net import InternalClient
    from pilosa_tpu_torch.net.client import ClientError

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "http_node")
    data_dir, log_path = os.path.join(work, "data"), os.path.join(work, "procnode.log")
    cfg = os.path.join(work, "workers.toml")
    with open(cfg, "w") as f:
        f.write("[server]\nworkers = 2\n")
    cmd = node_cmd or [sys.executable, "-m", "pilosa_tpu_torch"]
    wn = {r: w[:node_shards] for r, w in w10.items()}
    _, wants = c2_queries(wn)
    out = {}
    port = _free_port()
    t0 = time.perf_counter()
    proc = _start_node(cmd, data_dir, port, log_path, extra=["-c", cfg])
    try:
        out["restart_ready_s"], _ = _wait_ready(proc, port, log_path, "with two workers")
        client = InternalClient(f"http://localhost:{port}", timeout=600)

        def counts(c, what):
            for text, w in zip(c2_texts, wants):
                doc = c.query("b10m", text)
                if doc["results"] != w or "traceID" not in doc:
                    raise AssertionError(f"procmode: node {what} {text}: {doc} != {w}")

        counts(client, "with two workers")
        srv = client._get("/debug/vars")["server"]
        pids = {int(k): v for k, v in srv["workerPids"].items()}
        if srv["backend"] != "process" or len(pids) != 2:
            raise AssertionError(f"procmode: the node's server: {srv}")
        os.kill(pids[0], signal.SIGKILL)
        probe = InternalClient(f"http://localhost:{port}", timeout=5.0, retries=0)
        t_kill = time.perf_counter()
        seen_503 = False
        while time.perf_counter() - t_kill < NODE_READY_S:
            try:
                probe._get("/readyz")
                if seen_503:
                    break
            except ClientError as e:
                # code None: a connection the kernel gave the killed
                # worker's listener, reset with it.
                if e.code not in (503, None):
                    raise
                seen_503 = seen_503 or e.code == 503
            time.sleep(0.05)
        else:
            raise AssertionError("procmode: /readyz did not turn 503 and back to 200 "
                                 f"within {NODE_READY_S} s of the kill")
        if not seen_503:
            raise AssertionError("procmode: /readyz never turned 503 after the kill")
        out["respawn_ready_s"] = time.perf_counter() - t_kill
        client = InternalClient(f"http://localhost:{port}", timeout=600)
        srv = client._get("/debug/vars")["server"]
        if srv["restarts"] < 1 or int(srv["workerPids"]["0"]) == pids[0]:
            raise AssertionError(f"procmode: no respawn: {srv}")
        counts(client, "after the kill")
        _stop_node(proc, log_path)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["seconds"] = time.perf_counter() - t0
    log(f"procmode: the node with [server] workers = 2 ready {out['restart_ready_s']:.3f} s "
        f"after its start on the http phase's data; a worker SIGKILLed, /readyz 503 then 200 "
        f"after {out['respawn_ready_s']:.3f} s; the c2 Counts exact before and after; "
        f"{out['seconds']:.3f} s")
    return out


# -- phase 5: the write path -------------------------------------------------

# -- the cluster phase --------------------------------------------------------

CLUSTER_NODES = 3
CLUSTER_REPLICAS = 2
CLUSTER_READY_S = 240.0  # each node loads ~3.3 GB and warms its stacks first
CLUSTER_REPS = 12  # timed queries of each kind, each a fresh one
CLUSTER_SET_ROW = 1  # field cl's row: a field of its own, so f and top keep their stacks


def cluster_placement(n_shards, n_nodes=CLUSTER_NODES, replicas=CLUSTER_REPLICAS):
    """{node id: [shards it owns]} and {shard: [owner ids, primary first]}
    by the port's placement (cluster.shard_nodes) over nodes n0..n{k-1}."""
    from pilosa_tpu_torch.cluster import Cluster, Node

    nodes = [Node(f"n{i}", f"http://n{i}", i == 0) for i in range(n_nodes)]
    c = Cluster(nodes[0], replica_n=replicas)
    c.nodes = list(nodes)
    owners = {sh: [n.id for n in c.shard_nodes("bench", sh)] for sh in range(n_shards)}
    owned = {n.id: [sh for sh in range(n_shards) if n.id in owners[sh]] for n in nodes}
    return owned, owners


def write_node_dirs(dirs, owned, owners, host, topology, threads=8):
    """Every node's data directory before it starts, with the port's
    Holder: index bench (as build_index: f and top, plus an empty field cl
    for the replicated Set) holding only the shards that node owns, each
    fragment's snapshot and ranked cache on disk, the node's id and the
    cluster's topology.  Each shard's fragment bytes are serialized once
    (``codec.serialize_rows``, what a snapshot writes) and written once,
    ``threads`` shards at a time: its second owner's file is a hard link
    to the first's, since the phase never writes f or top (a node appends
    to a fragment's file only when it writes that fragment, and replaces
    it whole when it snapshots).  The ranked caches are written for each
    owner.  Returns {(field, shard): the shard's first file}."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.core.view import VIEW_STANDARD
    from pilosa_tpu_torch.ops.bitops import popcount_np
    from pilosa_tpu_torch.roaring import codec

    fields = (("f", F_ROWS), ("top", TOP_ROWS))
    paths = {}  # (node id, field, shard) -> the fragment's file
    for nid, data_dir in dirs.items():
        os.makedirs(data_dir, exist_ok=True)
        holder = Holder(data_dir, device="cpu")
        holder.open()
        idx = holder.create_index("bench")
        for name, _ in fields:
            view = idx.create_field(name).view_if_not_exists(VIEW_STANDARD)
            for sh in owned[nid]:
                paths[nid, name, sh] = view.fragment_if_not_exists(sh).path
        idx.create_field("cl")
        holder.close()
        with open(os.path.join(data_dir, ".id"), "w") as f:
            f.write(nid)
        with open(os.path.join(data_dir, ".topology"), "w") as f:
            json.dump({"nodes": topology}, f)

    def one(sh):
        for name, rows in fields:
            words = [host[name][r][sh] for r in rows]
            data = codec.serialize_rows((r, w, None) for r, w in zip(rows, words))
            cache = json.dumps({"pairs": [[r, int(popcount_np(w))] for r, w in zip(rows, words)]})
            first = paths[owners[sh][0], name, sh]
            with open(first, "wb") as f:
                f.write(data)
            for nid in owners[sh]:
                path = paths[nid, name, sh]
                if path != first:
                    os.remove(path)
                    os.link(first, path)
                with open(path + ".cache", "w") as f:
                    f.write(cache)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, sorted(owners)))
    return {(name, sh): paths[owners[sh][0], name, sh] for name, _ in fields for sh in owners}


def cluster_config(path, i, gossip_ports, budget):
    seeds = "" if i == 0 else f'seeds = ["127.0.0.1:{gossip_ports[0]}"]\n'
    with open(path, "w") as f:
        f.write(
            "[cluster]\n"
            f"replicas = {CLUSTER_REPLICAS}\n"
            f"coordinator = {'true' if i == 0 else 'false'}\n"
            "[gossip]\n"
            f"port = {gossip_ports[i]}\n"
            + seeds +
            'probe-interval = "200ms"\n'
            'probe-timeout = "100ms"\n'
            'push-pull-interval = "1s"\n'
            "suspicion-mult = 2\n"
            "[anti-entropy]\n"
            'interval = "1h"\n'
            "[engine]\n"
            f"device-budget-bytes = {budget}\n")


def slab_inputs(engine, shards, src_row=10, n=5):
    """K9's arguments as TorchEngine.topn_device_full builds them, for
    TopN(top, Row(f=src_row), n) over ``shards`` of the main engine."""
    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel import fusion

    canonical = engine.canonical_shards("bench")
    stack = engine.field_stack("bench", "top", "standard", canonical)
    entry = engine._topn_slab_candidates("bench", "top", stack)
    K_pad = entry.host_cnt.shape[1]
    k_out = min(K_pad, fusion._pow2(max(2 * n, 8)))
    mask = engine._mask_words(shards, canonical)
    src = pql.parse(f"Row(f={src_row})").calls[0]
    prog, lw = engine._lower_src("bench", src, canonical)
    return (prog, lw.mats, mask, stack.matrix, entry.cand_idx, entry.dev_cnt, 1, n, k_out), lw


def time_slab(engine, device, err, shards):
    """K9 at the cluster phase's shape on the main engine: node 0's shards
    of top's 960 masked in, TopN(top, Row(f=10), n=5): exact against its
    plain version, then timed beside it.  Returns the times and the bytes
    of its bound: the candidate and src rows of the masked shards, 128 KiB
    each, read once."""
    import torch

    from pilosa_tpu_torch.parallel import kernels

    args, lw = slab_inputs(engine, shards)
    got = kernels.topn_slab_tree(*args)
    torch.cuda.synchronize()
    want = kernels.topn_slab_tree_plain(*args)
    for g, w, part in zip(got, want, ("vals", "idx", "qual")):
        err["topn_slab"] = max(err.get("topn_slab", 0),
                               _exact("K9", g, w, f"{part} at the cluster phase's shape"))
    n_real = len(TOP_ROWS)
    byts = (n_real + len(lw.mats)) * len(shards) * 32768 * 4
    K_pad = args[4].shape[0]
    # Two bitonic sorts of K_pad keys a shard: log2(K)(log2(K)+1)/2 steps,
    # K/2 compare-exchanges a step, about 4 integer operations each.
    lg = K_pad.bit_length() - 1
    ops = 2 * (lg * (lg + 1) // 2) * (K_pad // 2) * 4 * len(shards)
    bound = least_ms(byts, ops)
    sync = torch.cuda.synchronize
    # Per call: the score and the selection kernels, one launch each.
    t = measured(lambda: kernels.topn_slab_tree(*args), "topn_slab", sync, per_call=True,
                 bound_ms=bound)
    plain = p50_ms(lambda: kernels.topn_slab_tree_plain(*args), 3, sync, batch=1)
    _times_line(f"K9 topn_slab (K_pad {K_pad}, {len(shards)} of 960 shards)", t, bound, plain,
                ", library: none (no popcount in PyTorch)")
    return t, plain, byts, ops


def _node_doc(client, path):
    return json.loads(client._get(path, raw=True))


def _cluster_query(client, q, want, what):
    got = client.query("bench", q)["results"][0]
    if isinstance(got, list):
        got = [(p["id"], p["count"]) for p in got]
    if got != want:
        raise AssertionError(f"cluster: {q} {what}: {got} != numpy {want}")
    return got


def run_cluster_path(device, holder, engine, host, seed, err, node_cmd=None,
                     n_shards=N_SHARDS, while_starting=None):
    """The cluster phase (module docstring).  Returns (out, kernels-line
    entry of K9).  ``while_starting(files)``, given {(field, shard): a file
    holding that fragment} of the data directories, runs while the nodes
    open them (the mesh phase writes its directories there, its f and top
    files hard links to these)."""
    import shutil
    import signal

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.net import InternalClient
    from pilosa_tpu_torch.net.server import serve

    cuda = device.type == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "cluster_nodes")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {"card": card_line()}
    owned, owners = cluster_placement(n_shards)
    out["shards_per_node"] = {k: len(v) for k, v in owned.items()}

    # K9 at the phase's shape, in this process.
    entry = None
    if cuda:
        t, plain, byts, ops = time_slab(engine, device, err, owned["n0"])
        out["k9_at_phase_shape"] = {"ms": t["ms"], "device_ms": t["device_ms"],
                                    "host_us": t["host_us"], "plain_ms": plain,
                                    "bound_ms": least_ms(byts, ops)}

    ports = [_free_port() for _ in range(CLUSTER_NODES)]
    gports = [_free_port() for _ in range(CLUSTER_NODES)]
    topology = [{"id": f"n{i}", "uri": f"http://localhost:{ports[i]}",
                 "isCoordinator": i == 0, "state": "READY", "devices": 1}
                for i in range(CLUSTER_NODES)]
    t0 = time.perf_counter()
    dirs = [os.path.join(work, f"n{i}") for i in range(CLUSTER_NODES)]
    files = write_node_dirs({f"n{i}": d for i, d in enumerate(dirs)}, owned, owners, host,
                            topology)
    node_bytes = max(len(v) for v in owned.values()) * (len(F_ROWS) + len(TOP_ROWS)) * 32768 * 4
    out["write_s"] = time.perf_counter() - t0
    log(f"cluster: wrote {CLUSTER_NODES} data directories ({out['shards_per_node']} shards, "
        f"{node_bytes / 1e9:.2f} GB of rows on the busiest) in {out['write_s']:.3f} s")

    cmd = node_cmd or [sys.executable, "-m", "pilosa_tpu_torch"]
    procs, logs = [], []
    clients = [InternalClient(f"http://localhost:{p}", timeout=600) for p in ports]
    try:
        t0 = time.perf_counter()
        for i in range(CLUSTER_NODES):
            cfg = os.path.join(work, f"n{i}.toml")
            cluster_config(cfg, i, gports, 2 * node_bytes)
            logs.append(os.path.join(work, f"n{i}.log"))
            procs.append(_start_node(cmd, dirs[i], ports[i], logs[i], extra=["-c", cfg]))
        if while_starting is not None:
            while_starting(files)
        for i in range(CLUSTER_NODES):
            _wait_ready(procs[i], ports[i], logs[i], f"(cluster node n{i})",
                        timeout=CLUSTER_READY_S)
        # Every node knows every shard once each node's NodeStatus, sent to
        # its peers when it serves, is through: Explain plans without
        # dispatching.
        for i, c in enumerate(clients):
            _poll(f"cluster: n{i} knows all {n_shards} shards",
                  lambda c=c: sum(c.query("bench", "Explain(Count(Row(f=10)))")["results"][0][k]
                                  for k in ("localShards", "remoteShards")) == n_shards, 60.0)
        out["ready_s"] = time.perf_counter() - t0
        st = _node_doc(clients[0], "/status")
        if st["state"] != "NORMAL" or len(st["nodes"]) != CLUSTER_NODES:
            raise AssertionError(f"cluster: /status of the coordinator: {st}")
        log(f"cluster: three nodes ready in {out['ready_s']:.3f} s; /status {st['state']}, "
            f"nodes {[n['id'] for n in st['nodes']]}")

        f, o = host["f"], TopNOracle(host["top"])
        count_q = "Count(Intersect(Row(f=10), Row(f=22)))"
        count_want = int(and_popcounts(f[10][:n_shards], f[22][:n_shards]).sum())
        topn_q = "TopN(top, Row(f=10), n=5)"
        topn_want = o.two_phase(f[10], 5)
        for i, c in enumerate(clients):
            _cluster_query(c, count_q, count_want, f"through n{i}")
            _cluster_query(c, topn_q, topn_want, f"through n{i}")
        launches = {}
        for i, c in enumerate(clients):
            dv = _node_doc(c, "/debug/vars")
            kl = dv["engine"]["kernelLaunches"]
            slab = dv["engineCaches"]["topnSlab"]
            launches[f"n{i}"] = {"count_tree_dense": kl["count_tree_dense"],
                                 "topn_slab": kl["topn_slab"], "slab": slab}
            if cuda and (kl["count_tree_dense"] <= 0 or kl["topn_slab"] <= 0):
                raise AssertionError(f"cluster: node n{i} launched no K1 or no K9: {kl}")
            if slab["served"] <= 0 or any(slab["declines"].values()):
                raise AssertionError(f"cluster: node n{i}'s slab lane: {slab}")
        out["launches"] = launches
        log(f"cluster: {count_q} and {topn_q} exact through every node; launches {launches}")

        # A Set through the node that owns no replica of the bit's shard.
        sh = next(x for x in range(n_shards) if "n1" not in owners[x])
        col = sh * (1 << 20) + 12345
        res = clients[1].query("bench", f"Set({col}, cl={CLUSTER_SET_ROW})")["results"]
        if res != [True]:
            raise AssertionError(f"cluster: Set through n1: {res}")
        for nid in owners[sh]:
            c = clients[int(nid[1:])]
            got = c.query("bench", f"Row(cl={CLUSTER_SET_ROW})", shards=[sh],
                          remote=True)["results"][0]["columns"]
            if got != [col]:
                raise AssertionError(f"cluster: owner {nid} of shard {sh} holds {got}, not "
                                     f"the Set's column {col}")
        out["set"] = {"shard": sh, "owners": owners[sh], "through": "n1"}
        log(f"cluster: Set({col}) through n1 read back from both owners {owners[sh]}")

        # Coordinator p50s, each query a fresh one, beside one node over
        # the main engine (in process, its memo off).
        pairs = [(10 + k, 22 + k) for k in range(CLUSTER_REPS)]
        srcs = [10 + k for k in range(CLUSTER_REPS)]

        def p50(client):
            ct, tt = [], []
            for a, b in pairs:
                t1 = time.perf_counter()
                client.query("bench", f"Count(Intersect(Row(f={a}), Row(f={b})))")
                ct.append(time.perf_counter() - t1)
            for a in srcs:
                t1 = time.perf_counter()
                client.query("bench", f"TopN(top, Row(f={a}), n=5)")
                tt.append(time.perf_counter() - t1)
            return statistics.median(ct) * 1e3, statistics.median(tt) * 1e3

        out["cluster_count_p50_ms"], out["cluster_topn_p50_ms"] = p50(clients[0])
        a, b = pairs[-1]
        _cluster_query(clients[0], f"Count(Intersect(Row(f={a}), Row(f={b})))",
                       int(and_popcounts(f[a][:n_shards], f[b][:n_shards]).sum()),
                       "(the last timed Count)")
        _cluster_query(clients[0], f"TopN(top, Row(f={srcs[-1]}), n=5)",
                       o.two_phase(f[srcs[-1]], 5), "(the last timed TopN)")
        api = API(holder=holder, engine=engine)
        srv, _ = serve(api, "localhost", 0)
        try:
            with memo_off(engine):
                one = InternalClient(f"http://localhost:{srv.server_address[1]}", timeout=600)
                out["single_count_p50_ms"], out["single_topn_p50_ms"] = p50(one)
        finally:
            srv.shutdown()
            srv.server_close()
        log(f"cluster: coordinator HTTP p50 Count {out['cluster_count_p50_ms']:.3f} ms, TopN "
            f"{out['cluster_topn_p50_ms']:.3f} ms; one node over the same index "
            f"{out['single_count_p50_ms']:.3f} ms and {out['single_topn_p50_ms']:.3f} ms")

        # Node n2 killed: the same reads fail over to the replicas.
        procs[2].send_signal(signal.SIGKILL)
        procs[2].wait(60)
        t0 = time.perf_counter()
        for i in (0, 1):
            _cluster_query(clients[i], count_q, count_want, f"through n{i} with n2 killed")
            _cluster_query(clients[i], topn_q, topn_want, f"through n{i} with n2 killed")
        out["failover_s"] = time.perf_counter() - t0
        log(f"cluster: n2 killed; {count_q} and {topn_q} exact through n0 and n1 "
            f"in {out['failover_s']:.3f} s")
    finally:
        for i, proc in enumerate(procs):
            if proc.poll() is None:
                try:
                    _stop_node(proc, logs[i])
                except AssertionError:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    raise
        shutil.rmtree(work, ignore_errors=True)
    if cuda:
        n_k9 = sum(v["topn_slab"] for v in out["launches"].values())
        entry = _entry("topn_slab", "pilosa_tpu_torch/csrc/topn_slab.cu",
                       "pilosa_tpu/parallel/kernels.py:396", n_k9, err["topn_slab"], t, plain,
                       byts, ops, None)
        entry["library"] = "none: no popcount in PyTorch"
    return out, entry


# -- the mesh phase -------------------------------------------------------------

MESH_RANKS = 2
MESH_FIELDS = ("f", "top", "v", "ga", "gb")
MESH_READY_S = 300.0  # each node opens the whole index (6.9 GB) before it serves
MESH_ROUNDS = 2  # interleaved rounds of every query, each client


def mesh_row_shards(n_shards):
    """The Row query's shards: two on each of the two ranks."""
    return (1, 2, n_shards - 2, n_shards - 1)


def write_mesh_dirs(holder, dirs, n_shards, linked=None, threads=8):
    """Both ranks' data directories before the nodes start: index bench
    with MESH_FIELDS at every shard (each rank's node holds the whole index,
    as the reference's processes replay the same data; a rank builds its
    stacks over its block only), from the main holder's rows as they are
    now.  Each fragment is serialized once (``codec.serialize_rows``) into
    the first directory and hard-linked into the other (no node writes
    these fields); a ranked cache is written beside each standard view's
    fragment.  ``linked`` maps (field, shard) to a file of the same
    fragment written already (the cluster phase's f and top): those are
    hard-linked, with their caches, and not serialized again."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.ops.bitops import popcount_np
    from pilosa_tpu_torch.roaring import codec

    linked = linked or {}
    src = holder.index("bench")
    views = [(name, vname) for name in MESH_FIELDS for vname in sorted(src.field(name).views)]
    paths = {}  # (directory, field, view, shard) -> the fragment's file
    for d in dirs:
        os.makedirs(d, exist_ok=True)
        h = Holder(d, device="cpu")
        h.open()
        idx = h.create_index("bench")
        for name in MESH_FIELDS:
            f = idx.create_field(name, src.field(name).options)
            for vname in src.field(name).views:
                view = f.view_if_not_exists(vname)
                for sh in range(n_shards):
                    paths[d, name, vname, sh] = view.fragment_if_not_exists(sh).path
        h.close()

    def one(sh):
        for name, vname in views:
            done = linked.get((name, sh)) if vname == "standard" else None
            if done is not None:
                for d in dirs:
                    path = paths[d, name, vname, sh]
                    os.remove(path)
                    os.link(done, path)
                    if os.path.exists(done + ".cache"):
                        if os.path.exists(path + ".cache"):
                            os.remove(path + ".cache")
                        os.link(done + ".cache", path + ".cache")
                continue
            frag = src.field(name).view(vname).fragment(sh)
            rows = frag.row_ids() if frag is not None else []
            words = [frag.row_words(r).view(np.uint64) for r in rows]
            first = paths[dirs[0], name, vname, sh]
            with open(first, "wb") as f:
                f.write(codec.serialize_rows((r, w, None) for r, w in zip(rows, words)))
            cache = None
            if vname == "standard":
                cache = json.dumps({"pairs": [[r, int(popcount_np(w))]
                                              for r, w in zip(rows, words)]})
            for d in dirs:
                path = paths[d, name, vname, sh]
                if path != first:
                    os.remove(path)
                    os.link(first, path)
                if cache is not None:
                    with open(path + ".cache", "w") as f:
                        f.write(cache)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, range(n_shards)))


def mesh_config(path, rank, coordinator, ports):
    """A rank's [mesh] keys: the process group at ``coordinator``, the other
    node as its peer, node 0 the sequencer."""
    peers = ", ".join(f'"http://localhost:{p}"' for i, p in enumerate(ports) if i != rank)
    sequencer = "self" if rank == 0 else f"http://localhost:{ports[0]}"
    with open(path, "w") as f:
        f.write("[mesh]\n"
                f'coordinator = "{coordinator}"\n'
                f"processes = {len(ports)}\n"
                f"process-id = {rank}\n"
                f"peers = [{peers}]\n"
                f'sequencer = "{sequencer}"\n')


def holder_rows(holder, field, view, rows, n_shards):
    """{row: uint64[S, W64]} words of ``rows`` of a view of index bench,
    read from the holder's fragments."""
    v = holder.index("bench").field(field).view(view)
    out = {}
    for r in rows:
        w = np.zeros((n_shards, W64), np.uint64)
        for sh in range(n_shards):
            frag = v.fragment(sh)
            if frag is not None:
                w[sh] = frag.row_words(r).view(np.uint64)
        out[r] = w
    return out


def bsi_extremes(planes, nn, is_min):
    """Per shard the extreme value of the not-null columns and how many
    columns hold it, by one greedy walk of the planes from the top (the
    plane walk of fragment.go min/max): (int64[S] values, int64[S]
    counts, bool[S] any column)."""
    cand = nn.copy()
    val = np.zeros(nn.shape[0], np.int64)
    for i in range(len(planes) - 1, -1, -1):
        sel = cand & (~planes[i] if is_min else planes[i])
        has = sel.any(axis=1)
        cand = np.where(has[:, None], sel, cand)
        if not is_min:
            val |= has.astype(np.int64) << i
        else:
            val |= (~has).astype(np.int64) << i
    counts = np.bitwise_count(cand).sum(axis=1).astype(np.int64)
    return val, counts, nn.any(axis=1)


def valcount(vals, counts, present, is_min):
    """The reference's ValCount reduce over the shards in canonical order:
    the extreme, and the count of the first shard holding it."""
    best, n = 0, 0
    for v, c, p in zip(vals.tolist(), counts.tolist(), present.tolist()):
        if p and (n == 0 or (v < best if is_min else v > best)):
            best, n = v, c
    return best, n


def mesh_wants(holder, host, n_shards):
    """(query, numpy answer) of the mesh phase, over the main holder's
    words as they are now."""
    from pilosa_tpu_torch.ops.bitops import popcount_np

    f = host["f"]
    bsig = holder.index("bench").field("v").bsi_group("v")
    depth = bsig.bit_depth()
    pl = holder_rows(holder, "v", "bsig_v", range(depth + 1), n_shards)
    planes, nn = [pl[i] for i in range(depth)], pl[depth]
    total = sum(popcount_np(planes[i] & nn) << i for i in range(depth))
    g = {**holder_rows(holder, "ga", "standard", range(G_ROWS["ga"]), n_shards),
         **{("b", r): w for r, w in
            holder_rows(holder, "gb", "standard", range(G_ROWS["gb"]), n_shards).items()}}
    groups = {}
    for a in range(G_ROWS["ga"]):
        for b in range(G_ROWS["gb"]):
            n = int(and_popcounts(g[a], g["b", b]).sum())
            if n:
                groups[a, b] = n
    row_shards = mesh_row_shards(n_shards)
    words = f[10][list(row_shards)] & f[22][list(row_shards)]
    cols = []
    for k, sh in enumerate(row_shards):
        bits = np.unpackbits(words[k].view(np.uint8), bitorder="little")
        cols.append(np.flatnonzero(bits) + (sh << 20))
    shards = ", ".join(map(str, row_shards))
    return [
        ("Count(Intersect(Row(f=10), Row(f=22)))",
         [int(and_popcounts(f[10][:n_shards], f[22][:n_shards]).sum())]),
        ("Count(Union(Row(f=11), Row(f=23)))Count(Xor(Row(f=12), Row(f=24)))",
         [popcount_np(f[11] | f[23]), popcount_np(f[12] ^ f[24])]),
        ("Sum(field=v)", [{"value": int(total) + bsig.min * popcount_np(nn),
                           "count": popcount_np(nn)}]),
        ("Min(field=v)", [dict(zip(("value", "count"),
                                   valcount(*bsi_extremes(planes, nn, True), True)))]),
        ("Max(field=v)", [dict(zip(("value", "count"),
                                   valcount(*bsi_extremes(planes, nn, False), False)))]),
        ("TopN(top, Row(f=10), n=5)", [TopNOracle(host["top"]).fused(f[10], 5)]),
        ("GroupBy(Rows(field=ga), Rows(field=gb))", [groups]),
        (f"Options(Intersect(Row(f=10), Row(f=22)), shards=[{shards}])",
         [np.concatenate(cols).tolist()]),
    ]


def _mesh_result(q, got):
    """A reply's results in the oracle's form."""
    if q.startswith("TopN"):
        return [[(p["id"], p["count"]) for p in got[0]]]
    if q.startswith("GroupBy"):
        return [{(x["group"][0]["rowID"], x["group"][1]["rowID"]): x["count"] for x in got[0]}]
    if q.startswith("Options"):
        return [got[0]["columns"]]
    if q.startswith(("Min", "Max", "Sum")):
        return [{"value": got[0]["value"], "count": got[0]["count"]}]
    return got


MESH_NODE_KERNELS = ("count_tree_dense", "count_batch_tree", "sum_tree", "minmax_tree",
                     "score_rows", "score_rows_trim", "groupn_tree", "eval_tree")


def mesh_dirs():
    """The ranks' data directories (``write_mesh_dirs``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    return [os.path.join(root, "build", "mesh_nodes", f"n{i}") for i in range(MESH_RANKS)]


def run_mesh_path(device, holder, host, seed, err, cluster, node_cmd=None, n_shards=N_SHARDS,
                  written_s=None):
    """The mesh phase (module docstring).  Returns its numbers and each
    node's kernel launches.  ``written_s``: the seconds the ranks' data
    directories (``mesh_dirs``) took to write while the cluster phase's
    nodes opened theirs; None: the phase writes them."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.net import InternalClient

    cuda = device.type == "cuda"
    dirs = mesh_dirs()
    work = os.path.dirname(dirs[0])
    out = {"card": card_line(), "ranks": MESH_RANKS}
    t0 = time.perf_counter()
    wants = mesh_wants(holder, host, n_shards)
    out["oracle_s"] = time.perf_counter() - t0
    if written_s is None:
        shutil.rmtree(work, ignore_errors=True)
        t0 = time.perf_counter()
        write_mesh_dirs(holder, dirs, n_shards)
        written_s = time.perf_counter() - t0
    out["write_s"] = written_s
    log(f"mesh: numpy answers in {out['oracle_s']:.3f} s; {MESH_RANKS} data directories of "
        f"index bench ({', '.join(MESH_FIELDS)}, {n_shards} shards) written in "
        f"{out['write_s']:.3f} s (during the cluster phase's node start, when run after it)")

    cmd = node_cmd or [sys.executable, "-m", "pilosa_tpu_torch"]
    ports = [_free_port() for _ in range(MESH_RANKS)]
    coordinator = f"127.0.0.1:{_free_port()}"
    clients = [InternalClient(f"http://localhost:{p}", timeout=600) for p in ports]
    procs, logs = [], []

    def vars_of(i):
        return _node_doc(clients[i], "/debug/vars")

    def psums():
        return [vars_of(i)["engine"]["mesh"]["psumDispatches"] for i in range(MESH_RANKS)]

    def check(i, q, want, what):
        got = _mesh_result(q, clients[i].query("bench", q)["results"])
        if got != want:
            raise AssertionError(f"mesh: {q} {what}: {str(got)[:300]} != numpy {str(want)[:300]}")

    try:
        t0 = time.perf_counter()
        for i in range(MESH_RANKS):
            cfg = os.path.join(work, f"mesh_n{i}.toml")
            mesh_config(cfg, i, coordinator, ports)
            logs.append(os.path.join(work, f"n{i}.log"))
            procs.append(_start_node(cmd, dirs[i], ports[i], logs[i], extra=["-c", cfg]))
        for i in range(MESH_RANKS):
            _wait_ready(procs[i], ports[i], logs[i], f"(mesh node n{i})", timeout=MESH_READY_S)
        out["ready_s"] = time.perf_counter() - t0
        for i in range(MESH_RANKS):
            mesh = vars_of(i)["engine"]["mesh"]
            if (mesh["rank"], mesh["world"]) != (i, MESH_RANKS):
                raise AssertionError(f"mesh: node n{i} is rank {mesh}")
        log(f"mesh: {MESH_RANKS} ranks ready in {out['ready_s']:.3f} s, "
            f"{n_shards // MESH_RANKS} of the {n_shards} canonical positions each")

        # Each kind once through n0: every node runs its part of the
        # collective (its psum-dispatch count moves).
        moved = {}
        for q, want in wants:
            before = psums()
            t1 = time.perf_counter()
            check(0, q, want, "through n0")
            took = time.perf_counter() - t1
            after = psums()
            moved[q] = [b - a for a, b in zip(before, after)]
            if any(m <= 0 for m in moved[q]):
                raise AssertionError(f"mesh: {q}: a node ran no dispatch: {moved[q]}")
            log(f"mesh: {q[:60]} exact through n0 in {took:.3f} s; dispatches a node {moved[q]}")
        out["dispatches"] = moved

        # Both nodes initiate at once under tickets, interleaved.
        errs = []

        def client(i):
            try:
                order = wants if i == 0 else wants[::-1]
                for _ in range(MESH_ROUNDS):
                    for q, want in order:
                        check(i, q, want, f"through n{i} (interleaved)")
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append((i, repr(e)[:2000]))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(MESH_RANKS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        if any(th.is_alive() for th in threads) or errs:
            raise AssertionError(f"mesh: interleaved clients: {errs or 'wedged'}")
        out["interleaved_s"] = time.perf_counter() - t0
        log(f"mesh: {MESH_ROUNDS} rounds of {len(wants)} queries from both nodes at once, "
            f"every answer exact, in {out['interleaved_s']:.3f} s")

        # The coordinator's HTTP p50s, each query a fresh one.
        pairs = [(10 + k, 22 + k) for k in range(CLUSTER_REPS)]
        ct, tt = [], []
        for a, b in pairs:
            t1 = time.perf_counter()
            clients[0].query("bench", f"Count(Intersect(Row(f={a}), Row(f={b})))")
            ct.append(time.perf_counter() - t1)
        for a, _ in pairs:
            t1 = time.perf_counter()
            clients[0].query("bench", f"TopN(top, Row(f={a}), n=5)")
            tt.append(time.perf_counter() - t1)
        out["mesh_count_p50_ms"] = statistics.median(ct) * 1e3
        out["mesh_topn_p50_ms"] = statistics.median(tt) * 1e3
        a, b = pairs[-1]
        check(0, f"Count(Intersect(Row(f={a}), Row(f={b})))",
              [int(and_popcounts(host["f"][a][:n_shards], host["f"][b][:n_shards]).sum())],
              "(the last timed Count)")
        for k in ("cluster_count_p50_ms", "cluster_topn_p50_ms", "single_count_p50_ms",
                  "single_topn_p50_ms"):
            out[k] = cluster.get(k)
        log(f"mesh: coordinator HTTP p50 Count {out['mesh_count_p50_ms']:.3f} ms, TopN "
            f"{out['mesh_topn_p50_ms']:.3f} ms; the cluster phase's coordinator "
            f"{out['cluster_count_p50_ms']} and {out['cluster_topn_p50_ms']} ms, one node "
            f"{out['single_count_p50_ms']} and {out['single_topn_p50_ms']} ms")

        nodes = {}
        for i in range(MESH_RANKS):
            dv = vars_of(i)
            mesh, kl = dv["engine"]["mesh"], dv["engine"]["kernelLaunches"]
            caches = dv["engineCaches"]
            nodes[f"n{i}"] = {
                "device_bytes": caches["residentBytes"], "host_fallbacks": caches["hostFallbacks"],
                "degraded": mesh["degraded"], "psum_dispatches": mesh["psumDispatches"],
                "reduces": mesh["reduces"], "reduce_ms_each":
                    mesh["reduceSeconds"] / max(1, mesh["reduces"]) * 1e3,
                "gathers": mesh["gathers"],
                "gather_ms_each": mesh["gatherSeconds"] / max(1, mesh["gathers"]) * 1e3,
                "eval_gathers": mesh["evalGathers"],
                "eval_gather_bytes_each": mesh["evalGatherBytes"] / max(1, mesh["evalGathers"]),
                "eval_gather_ms_each":
                    mesh["evalGatherSeconds"] / max(1, mesh["evalGathers"]) * 1e3,
                "launches": {k: kl[k] for k in MESH_NODE_KERNELS},
            }
            n = nodes[f"n{i}"]
            if n["host_fallbacks"] or n["degraded"]:
                raise AssertionError(f"mesh: node n{i} fell back to the host lane: {n}")
            if cuda and any(v <= 0 for v in n["launches"].values()):
                raise AssertionError(f"mesh: node n{i} did not launch every kernel: {n}")
            if not n["gathers"] or not n["eval_gathers"]:
                raise AssertionError(f"mesh: node n{i} ran no all-gather: {n}")
        out["nodes"] = nodes
        log("mesh: " + "; ".join(
            f"{k} {v['device_bytes'] / 1e9:.2f} GB on the card, gloo all-gather of a Row's "
            f"words {v['eval_gather_ms_each']:.1f} ms each ({v['eval_gather_bytes_each'] / 1e6:.1f}"
            f" MB a rank), of per-shard results {v['gather_ms_each']:.3f} ms, all-reduce "
            f"{v['reduce_ms_each']:.3f} ms (the initiator's include the wait for its peer)"
            for k, v in nodes.items()))
    finally:
        # Both ranks stop at once (SIGTERM, each its own wait).
        t0 = time.perf_counter()
        live = [i for i, proc in enumerate(procs) if proc.poll() is None]
        with ThreadPoolExecutor(max(1, len(live))) as pool:
            stops = [pool.submit(_stop_node, procs[i], logs[i]) for i in live]
        for i, stop in zip(live, stops):
            if stop.exception() is not None and procs[i].poll() is None:
                procs[i].kill()
                procs[i].wait()
        out["stop_s"] = time.perf_counter() - t0
        shutil.rmtree(work, ignore_errors=True)
        for stop in stops:
            if stop.exception() is not None:
                raise stop.exception()
    return out


OCC_BLOCK_BITS = 1 << 14  # 64 occupancy blocks of 2 KiB per 2^20-bit shard row
NEW_ROW = 99  # no field of the index has this row


def _bit(words, col):
    """Bit ``col`` (a column of the index) of uint64[S, W64] host words."""
    sh, pos = divmod(col, 1 << 20)
    return int(words[sh, pos >> 6] >> np.uint64(pos & 63)) & 1


def _put(words, col, on):
    sh, pos = divmod(col, 1 << 20)
    m = np.uint64(1) << np.uint64(pos & 63)
    words[sh, pos >> 6] = words[sh, pos >> 6] | m if on else words[sh, pos >> 6] & ~m


def _flat_index(cols):
    """Word index into flattened uint64[S, W64] host words, and bit mask,
    of each column of int64[n] ``cols``."""
    return ((cols >> 20) * W64 + ((cols & ((1 << 20) - 1)) >> 6),
            np.uint64(1) << (cols & 63).astype(np.uint64))


def _occupied(words, sh):
    """bool[64]: which occupancy blocks of shard ``sh`` hold a bit."""
    return words[sh].reshape(64, 256).any(axis=1)


def write_targets(rng, a, b, n_shards, n, sparse):
    """(verb, column) for ``n`` Sets and ``n`` Clears of row ``a`` (host
    words), read back by Count(Intersect(a, b)).  A Set goes where ``a``
    has no bit and ``b`` has one, so the Count must move; with ``sparse``,
    half the Sets go into a block ``a`` leaves empty (its occupancy bit is
    0) and ``b`` occupies.  A Clear goes where both have the bit."""
    out, filled = [], set()
    while len(out) < 2 * n:
        sh = int(rng.integers(0, n_shards))
        verb = "Set" if len(out) % 2 == 0 else "Clear"
        into_empty = sparse and verb == "Set" and len(out) % 4 == 0
        if into_empty:  # each into its own block
            blocks = [k for k in np.flatnonzero(_occupied(b, sh) & ~_occupied(a, sh)).tolist()
                      if (sh, k) not in filled]
        else:
            blocks = np.flatnonzero(_occupied(b, sh) & _occupied(a, sh)).tolist()
        if not blocks:
            continue
        blk = int(rng.choice(blocks))
        if into_empty:
            filled.add((sh, blk))
        base = sh * (1 << 20) + blk * OCC_BLOCK_BITS
        for pos in rng.permutation(OCC_BLOCK_BITS)[:256].tolist():
            col = base + pos
            if _bit(b, col) and _bit(a, col) == (verb == "Clear") and (verb, col) not in out:
                out.append((verb, col))
                break
    return out


NATIVE_REPS = 2
NATIVE_BITS = 1 << 20  # bits in one import batch


@contextlib.contextmanager
def numpy_paths():
    """The host's numpy paths in place of native/'s libraries, as on a
    host without a compiler."""
    from pilosa_tpu_torch import native
    from pilosa_tpu_torch.core import rowstore

    saved = native.load, native.load_merge, rowstore._MERGE
    native.load = native.load_merge = lambda: None
    rowstore._MERGE = False
    try:
        yield
    finally:
        native.load, native.load_merge, rowstore._MERGE = saved


def run_native_ab(seed):
    """The native phase, host only: each path that native/ takes, timed
    against the numpy path it stands in for, in turns in this process
    (best of NATIVE_REPS a side, host ms; the results of the last kept
    and compared).  Ingest: two batches of
    NATIVE_BITS bits through Field.import_bulk (the shard split and the
    rows' merge), over 96 shards x 64 rows (sparse rows) and over 16
    shards x 8 rows (dense rows: the dense apply).  A fragment's load
    (codec.deserialize) and codec.serialize, of array, bitmap and run
    containers.  Every native result must equal the numpy one.  Returns
    {path: {native_ms, numpy_ms, speedup}}."""
    import torch

    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.roaring import codec

    rng = np.random.default_rng(seed + 7)
    cpu = torch.device("cpu")

    def ingest(n_shards, n_rows):
        batches = [(rng.integers(0, n_rows, NATIVE_BITS), rng.integers(0, n_shards << 20,
                                                                       NATIVE_BITS))
                   for _ in range(2)]

        def run(keep):
            field = Holder(device=cpu).create_index("nat").create_field("f")
            t = time.perf_counter()
            for rows, cols in batches:
                field.import_bulk(rows, cols)
            dt = time.perf_counter() - t
            frags = field.view_if_not_exists("standard").fragments
            return dt, [(s, frags[s].positions()) for s in sorted(frags)] if keep else None
        return run

    def codec_run(fn, arg):
        def run(keep):
            t = time.perf_counter()
            got = fn(arg)
            return time.perf_counter() - t, got
        return run

    shapes = {
        "array": np.unique(rng.integers(0, 64 << 20, 1 << 20).astype(np.uint64)),
        "bitmap": np.unique(rng.integers(0, 8 << 20, 1 << 22).astype(np.uint64)),
        "run": np.concatenate([np.arange(k << 20, (k << 20) + 300000, dtype=np.uint64)
                               for k in range(16)])}
    paths = {"ingest_sparse_96x64": ingest(96, 64), "ingest_dense_16x8": ingest(16, 8)}
    for name, vals in shapes.items():
        data = codec._serialize_py(vals)
        paths[f"load_{name}"] = codec_run(lambda d: codec.deserialize(d).values, data)
        paths[f"serialize_{name}"] = codec_run(codec.serialize, vals)
    out = {}
    for name, run in paths.items():
        best, got = {"native": [], "numpy": []}, {}
        for rep in range(NATIVE_REPS):
            for side in ("native", "numpy"):
                with contextlib.ExitStack() as st:
                    if side == "numpy":
                        st.enter_context(numpy_paths())
                    dt, got[side] = run(rep == NATIVE_REPS - 1)
                best[side].append(dt * 1e3)
        a, b = got["native"], got["numpy"]
        if isinstance(a, list):  # an ingest: (shard, positions) a fragment
            same = len(a) == len(b) and all(sa == sb and np.array_equal(pa, pb)
                                            for (sa, pa), (sb, pb) in zip(a, b))
        else:
            same = a == b if isinstance(a, bytes) else np.array_equal(a, b)
        if not same:
            raise AssertionError(f"native: {name} differs from its numpy path")
        n, p = min(best["native"]), min(best["numpy"])
        out[name] = {"native_ms": n, "numpy_ms": p, "speedup": p / n}
    return out


def run_write_path(device, holder, engine, ex, host, seed):
    """The write path on the 960-shard index: single-bit Sets and Clears
    through Executor.execute on rows of f (dense) and s (sparse), each
    read back by a Count(Intersect) against a numpy oracle kept beside
    it; a bulk import of 2^20 bits into f synced by the IngestSyncer;
    writes to top, then an engine TopN; then one write to a new row,
    which must rebuild exactly once.  The stacks sync in place: no
    rebuild until that last write.  Returns the phase's numbers."""
    import torch

    from pilosa_tpu_torch.parallel import kernels, sparse

    cuda = device.type == "cuda"  # False only in a CPU rehearsal
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n_shards = len(engine.canonical_shards("bench"))
    rng = np.random.default_rng(seed + 4)
    t0 = time.perf_counter()
    # The fragments hold the host arrays themselves: the oracle is a copy.
    ora = {"f": {r: host["f"][r].copy() for r in F_ROWS},
           "s": {r: host["s"][r].copy() for r in (10, 11)},
           "top": {r: host["top"][r].copy() for r in TOP_ROWS}}
    log(f"write: oracle copies in {time.perf_counter() - t0:.3f} s")
    rebuilds0, updates0 = engine.stack_rebuilds, engine.stack_updates
    zero_counts(("count_tree_dense", "count_tree_blocks", "score_rows"))

    # 1. Single-bit writes, each read back by the Count that must see it.
    # The host clock splits each into the executor's Set, the stack sync
    # (the snapshot and the scatter's enqueue, which the Count would run
    # first) and the Count; inside the scatter, the pinned uploads.
    scatter_us, upload_us = [], []
    scatter, upload = engine._scatter_chain, engine._upload

    def timed(fn, acc):
        def run(*a):
            t = time.perf_counter()
            out = fn(*a)
            acc.append((time.perf_counter() - t) * 1e6)
            return out
        return run

    engine._scatter_chain = timed(scatter, scatter_us)
    engine._upload = timed(upload, upload_us)
    lat = {"f": [], "s": []}
    parts = {"set": [], "sync": [], "count": []}
    filled = 0
    # Memo off: every Count below dispatches (a write moves its key
    # anyway), the execute_async one through the batcher too.
    memo = contextlib.ExitStack()
    memo.enter_context(memo_off(engine))
    for field, path in (("f", "dense"), ("s", "sparse")):
        a, b = ora[field][10], ora[field][11]
        q = pql_of(field, "and", (10, 11))
        want = int(popcounts(a & b).sum())
        st = engine.field_stack("bench", field, "standard")
        ri = st.row_index[10]
        for verb, col in write_targets(rng, a, b, n_shards, 16, field == "s"):
            sh, blk = col >> 20, (col & ((1 << 20) - 1)) // OCC_BLOCK_BITS
            was_empty = not (int(st.occ[ri, sh]) >> blk) & 1
            t = time.perf_counter()
            ex.execute("bench", f"{verb}({col}, {field}=10)")
            t1 = time.perf_counter()
            engine.field_stack("bench", field, "standard")
            t2 = time.perf_counter()
            got = ex.execute("bench", q).results[0]
            t3 = time.perf_counter()
            lat[field].append((t3 - t) * 1e3)
            for k, v in (("set", t1 - t), ("sync", t2 - t1), ("count", t3 - t2)):
                parts[k].append(v * 1e3)
            _put(a, col, verb == "Set")
            want += 1 if verb == "Set" else -1
            if got != want or engine.last_path != path:
                raise AssertionError(f"{verb}({col}, {field}=10) then {q}: port {got} "
                                     f"on {engine.last_path} != numpy oracle {want} on {path}")
            fut = ex.execute_async("bench", q)
            if fut is None or fut.result(300).results[0] != want:
                raise AssertionError(f"{verb}({col}, {field}=10) then {q} through execute_async: "
                                     f"{None if fut is None else fut.result(0).results} != {want}")
            if was_empty and verb == "Set":
                filled += 1
                if not (int(st.occ[ri, sh]) >> blk) & 1:
                    raise AssertionError(f"occupancy bit {blk} of s=10, shard {sh} not set")
        if want != int(popcounts(a & b).sum()):
            raise AssertionError(f"{field}: the oracle's running count drifted")
    if filled < 8:
        raise AssertionError(f"only {filled} Sets went into empty blocks of s")
    del engine._scatter_chain, engine._upload
    batched_ryw = read_your_writes(engine, ex, ora, rng, n_shards)
    memo.close()
    parts = {k: statistics.median(v) for k, v in parts.items()}
    log(f"write: 32 Sets and 32 Clears on f=10 and s=10, each then Count(Intersect) exact "
        f"against numpy ({filled} Sets into blocks s=10 left empty, counted on the sparse "
        f"path); write->Count p50 f {statistics.median(lat['f']):.4f} ms, s "
        f"{statistics.median(lat['s']):.4f} ms (p50 of its parts, ms: {json.dumps(parts)}); "
        f"scatter host p50 {statistics.median(scatter_us):.1f} us over {len(scatter_us)} "
        f"syncs, of which its {len(upload_us) // max(1, len(scatter_us))} pinned uploads "
        f"{statistics.median(upload_us):.1f} us each (p50); each Count again through "
        f"execute_async exact")

    # The scatter on the card: one Set and the dense Count that syncs it,
    # the sync inside the profiled window (stack_updates moves by one) and
    # index_put_'s kernel in its list.
    q = pql_of("f", "and", (10, 11))

    def run():
        col = next(c for v, c in write_targets(rng, ora["f"][10], ora["f"][11], n_shards, 1,
                                                False) if v == "Set")
        ex.execute("bench", f"Set({col}, f=10)")
        _put(ora["f"][10], col, True)
        synced = engine.stack_updates
        with repairs_off(engine):  # the main path's entry would repair it
            got = ex.execute("bench", q).results[0]
        if got != int(popcounts(ora["f"][10] & ora["f"][11]).sum()):
            raise AssertionError("the profiled write->Count disagrees with numpy")
        if engine.stack_updates != synced + 1:
            raise AssertionError("the profiled Count did not sync the stack in place")

    scattered = lambda seen: any("index_put" in k for k in seen)  # noqa: E731
    seen = on_card(run, scattered) if cuda else run() or {}
    scat = {k: v for k, v in per_launch(seen).items() if "index_put" in k}
    if cuda and not scat:
        raise AssertionError(f"no scatter kernel in the profiler's list: {seen}")
    log("write: one Set then Count on the card (torch.profiler): " + json.dumps(per_launch(seen)))

    # 2. Bulk import into f, synced by the ingest worker.
    n = 1 << 20
    rows = rng.choice(np.asarray(F_ROWS), n)
    cols = rng.integers(0, n_shards << 20, n)
    t = time.perf_counter()
    holder.index("bench").field("f").import_bulk(rows, cols)
    import_s = time.perf_counter() - t
    t = time.perf_counter()
    syncer = engine.ingest_syncer()
    syncer.notify("bench")
    if not syncer.flush(timeout=300):
        raise AssertionError("the ingest sync did not finish")
    sync()
    bulk_sync_s = time.perf_counter() - t
    if syncer.last_error is not None:
        raise AssertionError(f"ingest sync failed: {syncer.last_error!r}")
    for r in F_ROWS:
        np.bitwise_or.at(ora["f"][r].reshape(-1), *_flat_index(cols[rows == r]))
    for field, op, qrows in main_path_queries():
        if field != "f":
            continue
        q = pql_of(field, op, qrows)
        got, want = ex.execute("bench", q).results[0], oracle(ora["f"], op, qrows)
        if got != want:
            raise AssertionError(f"after the bulk import, {q}: port {got} != numpy oracle {want}")
    log(f"write: import_bulk of {n} bits into f's 24 rows over {n_shards} shards in "
        f"{import_s:.3f} s; IngestSyncer notify + flush (the scatter included) "
        f"{bulk_sync_s:.3f} s; the 15 f Counts exact against numpy")

    # 3. Writes to top, then the engine TopN.
    src = ora["f"][10]
    cand = rng.integers(0, n_shards << 20, 1 << 19)
    wi, m = _flat_index(cand)
    cand = cand[(src.reshape(-1)[wi] & m) != 0][: 1 << 18]
    holder.index("bench").field("top").import_bulk(np.full(cand.size, 2), cand)
    np.bitwise_or.at(ora["top"][2].reshape(-1), *_flat_index(cand))
    for c in cand[:4].tolist():
        ex.execute("bench", f"Clear({c}, top=2)")
        _put(ora["top"][2], c, False)
    q = "TopN(top, Row(f=10), n=5)"
    want = TopNOracle(ora["top"]).fused(src, 5)
    got = [tuple(p) for p in ex.execute("bench", q).results[0]]
    if got != want:
        raise AssertionError(f"after writes to top, {q}: port {got} != numpy oracle {want}")
    log(f"write: {cand.size} bits into top=2 and 4 Clears, then {q} -> {got}, exact")

    # 4. Whole-row writes: ClearRow of f=33 and s=33 (rows no other check
    # of this phase reads), then a Store of an Intersect into b10m's
    # existing row f=227, each followed by Counts against the oracle; each
    # syncs the resident stack in place.
    whole = {}
    for field, other in (("f", ora["f"][32]), ("s", host["s"][32])):
        upd = engine.stack_updates
        t = time.perf_counter()
        res = ex.execute("bench", f"ClearRow({field}=33)").results
        clear_s = time.perf_counter() - t
        if field == "f":
            ora["f"][33][:] = 0
        for q, want in ((f"Count(Union(Row({field}=32), Row({field}=33)))",
                         int(popcounts(other).sum())),
                        (f"Count(Intersect(Row({field}=32), Row({field}=33)))", 0)):
            got = ex.execute("bench", q).results[0]
            if res != [True] or got != want:
                raise AssertionError(f"ClearRow({field}=33) -> {res}, then {q}: port {got} != "
                                     f"numpy oracle {want}")
        whole[f"clear_row_{field}_s"] = clear_s
        if engine.stack_updates <= upd:
            raise AssertionError(f"ClearRow({field}=33) did not sync the stack in place")
    b10 = {r: np.stack([holder.fragment("b10m", "f", "standard", sh).row_words(r).view(np.uint64)
                        for sh in range(N_SHARDS_10M)]) for r in (100, 101, 226)}
    engine.field_stack("b10m", "f", "standard")
    upd = engine.stack_updates
    q = "Store(Intersect(Row(f=100), Row(f=101)), f=227)"
    t = time.perf_counter()
    res = ex.execute("b10m", q).results
    whole["store_b10m_s"] = time.perf_counter() - t
    for cq, want in (("Count(Intersect(Row(f=227), Row(f=226)))",
                      int(popcounts(b10[100] & b10[101] & b10[226]).sum())),
                     ("Count(Xor(Row(f=227), Intersect(Row(f=100), Row(f=101))))", 0)):
        got = ex.execute("b10m", cq).results[0]
        if res != [True] or got != want:
            raise AssertionError(f"{q} -> {res}, then {cq}: port {got} != numpy oracle {want}")
    if engine.stack_updates <= upd:
        raise AssertionError(f"{q} did not sync b10m's stack in place")
    log(f"write: ClearRow(f=33) {whole['clear_row_f_s']:.3f} s and ClearRow(s=33) "
        f"{whole['clear_row_s_s']:.3f} s over {n_shards} shards, {q} on b10m "
        f"{whole['store_b10m_s']:.3f} s; the Counts after each exact against numpy, each "
        "stack synced in place")

    # 5. Counts: no rebuild so far; one write to a new row rebuilds once.
    launches = {"count_tree_dense": kernels.count_tree_dense.launches,
                "count_tree_blocks": sparse.count_tree_blocks_cuda.launches,
                "score_rows": kernels.score_rows_cuda.launches}
    updates = engine.stack_updates - updates0
    if (engine.stack_rebuilds != rebuilds0 or updates <= 0 or ex.async_fallbacks
            or (cuda and min(launches.values()) <= 0)):
        raise AssertionError(f"write phase: rebuilds {engine.stack_rebuilds - rebuilds0} "
                             f"(want 0), updates {updates}, launches {launches}, "
                             f"_QueryFuture fallbacks {ex.async_fallbacks} (want 0)")
    col = int(rng.integers(0, n_shards << 20))
    ex.execute("bench", f"Set({col}, f={NEW_ROW})")
    t = time.perf_counter()
    engine.field_stack("bench", "f", "standard")
    sync()
    rebuild_s = time.perf_counter() - t
    q = f"Count(Intersect(Row(f={NEW_ROW}), Row(f=10)))"
    for _ in range(2):
        got = ex.execute("bench", q).results[0]
        if got != _bit(ora["f"][10], col):
            raise AssertionError(f"{q}: port {got} != numpy oracle {_bit(ora['f'][10], col)}")
    if engine.stack_rebuilds != rebuilds0 + 1:
        raise AssertionError(f"a write to a new row made {engine.stack_rebuilds - rebuilds0} "
                             "rebuilds, not 1")
    log(f"write: stack_rebuilds +0 through the writes above, stack_updates +{updates}; "
        f"a write to new row f={NEW_ROW} rebuilt f once, in {rebuild_s:.3f} s (25 rows), "
        f"against the bulk sync's {bulk_sync_s:.3f} s; launches {launches}")
    return {
        "write_count_p50_ms": {k: statistics.median(v) for k, v in lat.items()},
        "write_count_parts_p50_ms": parts,
        "scatter_host_us_p50": statistics.median(scatter_us),
        "scatter_upload_host_us_p50": statistics.median(upload_us),
        "scatter_kernels": scat,
        "bulk_import_s": import_s,
        "bulk_sync_s": bulk_sync_s,
        "rebuild_s": rebuild_s,
        "stack_updates": updates,
        "launches": launches,
        "batched_read_your_writes": batched_ryw,
        "whole_row_writes_s": whole,
    }


def read_your_writes(engine, ex, ora, rng, n_shards, readers=16, n_sets=24):
    """One writer thread Sets bits of f=12 where f=13 has them, beside
    ``readers`` threads that each submit three Counts over those rows at
    once through execute_async and wait on all three: Intersect (moves up
    by one per Set), Difference(f=13, f=12) (down by one) and Union
    (still).  Distinct trees in one drain make K5 launches, which the
    batcher's dispatch thread orders against the writes' in-place
    scatters.  Every Count submitted after a Set returned sees it, none
    sees more Sets than were made, K5 launched and no _QueryFuture fell
    back."""
    import threading

    from pilosa_tpu_torch.parallel import kernels

    a, b = ora["f"][12], ora["f"][13]
    cols = [c for v, c in write_targets(rng, a, b, n_shards, n_sets, False) if v == "Set"]
    n = len(cols)
    qs = {pql_of("f", "and", (12, 13)): 1, pql_of("f", "andnot", (13, 12)): -1,
          pql_of("f", "or", (12, 13)): 0}
    ora2 = {"f": {12: a, 13: b}}
    base = {q: int(oracle(ora2["f"], op, rows)) for q, (op, rows) in
            zip(qs, (("and", (12, 13)), ("andnot", (13, 12)), ("or", (12, 13))))}
    for q in qs:
        if ex.execute("bench", q).results[0] != base[q]:
            raise AssertionError(f"{q} before the writes disagrees with numpy")
    fallbacks0 = ex.async_fallbacks
    k5_0 = kernels.count_batch_tree_cuda.launches
    done = [0]
    stop = threading.Event()
    errors, seen = [], []

    def writer():
        try:
            for col in cols:
                ex.execute("bench", f"Set({col}, f=12)")
                done[0] += 1
                time.sleep(0.02)  # several reader rounds between Sets
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                n0 = done[0]
                futs = [(q, ex.execute_async("bench", q)) for q in qs]
                for q, fut in futs:
                    got = fut.result(300).results[0]
                    seen.append((n0, got))
                    lo, hi = sorted((base[q] + qs[q] * n0, base[q] + qs[q] * n))
                    if not lo <= got <= hi:
                        raise AssertionError(f"submitted after {n0} of {n} Sets returned, {q} "
                                             f"saw {got}, outside [{lo}, {hi}]")
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    rs = [threading.Thread(target=reader) for _ in range(readers)]
    w = threading.Thread(target=writer)
    t0 = time.perf_counter()
    for t in rs + [w]:
        t.start()
    w.join(300)
    time.sleep(0.05)
    stop.set()
    for t in rs:
        t.join(300)
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"read-your-writes under batching: {errors[:3]}")
    k5 = kernels.count_batch_tree_cuda.launches - k5_0
    fallbacks = ex.async_fallbacks - fallbacks0
    for col in cols:
        _put(a, col, True)
    for q, (op, rows) in zip(qs, (("and", (12, 13)), ("andnot", (13, 12)), ("or", (12, 13)))):
        final = ex.execute_async("bench", q).result(300).results[0]
        if final != int(oracle(ora2["f"], op, rows)) or final != base[q] + qs[q] * n:
            raise AssertionError(f"after the writes, {q}: {final} != {base[q] + qs[q] * n}")
    if fallbacks or (engine.device.type == "cuda" and k5 <= 0):
        raise AssertionError(f"read-your-writes under batching: {k5} K5 launches (want > 0), "
                             f"{fallbacks} _QueryFuture fallbacks (want 0)")
    log(f"write: {n} Sets on f=12 beside {readers} execute_async readers of Intersect, "
        f"Difference and Union of f=12 and f=13: {len(seen)} Counts in {wall:.3f} s, each saw "
        f"every Set that returned before it was submitted; {k5} K5 launches, {fallbacks} "
        "_QueryFuture fallbacks")
    return {"sets": n, "readers": readers, "counts": len(seen), "wall_s": wall,
            "k5_launches": k5, "fallbacks": fallbacks}


def root_writes(engine, ex, holder, host, seed):
    """--root's write items: write->Count p50 (three Sets on f=10 and
    three on s=10, each then the Count that must see it), and the bulk
    import of phase 5 then the sync that makes it visible: the ingest
    worker where the checkout has one, else the rebuild the next query
    pays.  Run last: it writes the index."""
    import torch

    rng = np.random.default_rng(seed + 4)
    n_shards = len(engine.canonical_shards("bench"))
    lat = []
    for field in ("f", "s"):
        a, b = host[field][10].copy(), host[field][11]
        q = pql_of(field, "and", (10, 11))
        want = int(popcounts(a & b).sum())
        for verb, col in write_targets(rng, a, b, n_shards, 3, field == "s"):
            if verb != "Set":
                continue
            t = time.perf_counter()
            ex.execute("bench", f"Set({col}, {field}=10)")
            got = ex.execute("bench", q).results[0]
            lat.append((time.perf_counter() - t) * 1e3)
            want += 1
            if got != want:
                raise AssertionError(f"Set({col}, {field}=10) then {q}: {got} != {want}")
    n = 1 << 20
    rows = rng.choice(np.asarray(F_ROWS), n)
    cols = rng.integers(0, n_shards << 20, n)
    holder.index("bench").field("f").import_bulk(rows, cols)
    t = time.perf_counter()
    if hasattr(engine, "ingest_syncer"):
        how = "ingest_syncer"
        syncer = engine.ingest_syncer()
        syncer.notify("bench")
        syncer.flush(timeout=300)
    else:
        how = "rebuild"
        engine.field_stack("bench", "f", "standard")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"write_count_p50_ms": statistics.median(lat), "write_count_ms": lat,
            "bulk_sync_s": time.perf_counter() - t, "bulk_sync_by": how,
            "stack_rebuilds": engine.stack_rebuilds,
            "stack_updates": getattr(engine, "stack_updates", None)}


# -- --root: one checkout's end-to-end numbers, for an A/B in one call ------


def run_ab(root, seed):
    """The end-to-end numbers of the pilosa_tpu_torch imported from
    ``root``, with this file's data, queries and timing loops (so two
    checkouts are measured the same way), and the main path's kernels on
    the card: one JSON line.  Host-clock numbers are compared only within
    one call, in turns (parent, change, change, parent)."""
    import torch

    import pilosa_tpu_torch
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.parallel import build, kernels
    from pilosa_tpu_torch.parallel.engine import TorchEngine

    pkg = os.path.dirname(os.path.abspath(pilosa_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise AssertionError(f"imported {pkg}, not the package under {root}")
    build.build(build.KERNELS)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    holder = Holder(device=device)
    host = build_index(holder, N_SHARDS, seed)
    engine = TorchEngine(holder, device=device)
    ex = Executor(holder, engine=engine)
    for field in ("f", "s", "top"):
        engine.field_stack("bench", field, "standard")
    torch.cuda.synchronize()
    log(f"ab: {pkg}: index and stacks in {time.perf_counter() - t0:.3f} s")

    # Warm engine-less TopN: the p50 of nine calls after a first that
    # builds the row mirrors.
    q = "TopN(top, Row(f=10), n=5)"
    want = TopNOracle(host["top"]).two_phase(host["f"][10], 5)

    def engine_less():
        got = [tuple(p) for p in Executor(holder).execute("bench", q).results[0]]
        if got != want:
            raise AssertionError(f"{q} (no engine): {got} != numpy oracle {want}")

    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine_less()
        walls.append((time.perf_counter() - t0) * 1e3)
    # The layer under it: Fragment.top of every shard's top fragment in
    # turn (one P2 launch and one readback each), p50 over three sweeps.
    frags = [(holder.fragment("bench", "top", "standard", sh),
              holder.fragment("bench", "f", "standard", sh).row(10)) for sh in range(N_SHARDS)]
    per_call = []
    for _ in range(3):
        for frag, src in frags:
            t0 = time.perf_counter()
            frag.top(n=5, src=src)
            per_call.append((time.perf_counter() - t0) * 1e6)
    for field in ("f", "s"):  # one warm-up pass each
        for k in range(12):
            ex.execute("bench", pql_of(field, "and", (10 + 2 * k, 11 + 2 * k)))
    ex.execute("bench", q)
    with memo_off(engine):  # the memo would answer the timing loops' repeats
        # The engine TopN in five windows of 36 queries: the host clock
        # spreads, so the p50 is the median of the windows' p50s.
        topn_windows = [topn_p50_ms(ex) for _ in range(5)]
        out = {
            "root": root,
            "dense_count_p50_ms": count_p50_ms(ex, "f"),
            "sparse_count_p50_ms": count_p50_ms(ex, "s"),
            "engine_topn_p50_ms": statistics.median(topn_windows),
            "engine_topn_windows_ms": topn_windows,
            "engine_less_topn_warm_ms": statistics.median(walls[1:]),
            "engine_less_topn_ms": walls,
            "fragment_top_us": statistics.median(per_call),
            # 8 K1 launches where Counts run one by one, one K5 where a
            # run of Counts is one count_many.
            "eight_counts_p50_ms": eight_count_p50_ms(ex),
        }
        out["eight_counts_kernels"] = per_launch(on_card(lambda: ex.execute("bench", eight_counts("f"))))
    # The main path's kernels on the card, after every host-clock window:
    # the 12 sparse Counts once each (K2) and one warm engine-less TopN
    # (P2, and whatever else that tree launches per shard).
    sparse_qs = [pql_of("s", "and", (10 + 2 * k, 11 + 2 * k)) for k in range(12)]
    with memo_off(engine):
        out["sparse_count_kernels"] = per_launch(on_card(lambda: [ex.execute("bench", x)
                                                                  for x in sparse_qs]))
    out["engine_less_topn_kernels"] = per_launch(on_card(engine_less))
    if hasattr(ex, "execute_async"):  # a checkout from before batched serving has none
        out["stream"] = ab_stream(engine, ex, host, seed)
    out["count_lanes"] = ab_count_lanes(engine, ex)
    out["http"] = ab_http(device, seed)
    out["kernels_at"] = ab_kernels(device, seed)
    out["pool"] = ab_pool(device, seed)
    out["residency"] = ab_residency(device)
    out["k1_kr"] = ab_k1_kr(engine, holder, seed)
    out.update(root_writes(engine, ex, holder, host, seed))
    out["card"] = card_line()
    print(json.dumps(out), flush=True)


def ab_count_lanes(engine, ex, rounds=4):
    """The lone Count's p50 (``count_p50_ms``, f dense and s sparse) with
    the executor's Count lane set to each engine entry in turn, in one
    process: ``engine.count`` (the lane before it went through the
    batcher) and ``engine.batched_count`` (the batcher's submit and
    direct path, the lane since), ``rounds`` alternations, the memo off.  Two processes'
    host times spread more than the lanes differ; one process compares
    the lanes alone."""
    lanes = {"engine_count": lambda i, c, s: engine.count(i, c, list(s)),
             "batched_count": lambda i, c, s: engine.batched_count(i, c, list(s))}
    own = ex._mesh_count
    out = {}
    try:
        with memo_off(engine):
            for _ in range(rounds):
                for name, fn in lanes.items():
                    ex._mesh_count = fn
                    for f in ("f", "s"):
                        out.setdefault(f"{name}_{f}", []).append(count_p50_ms(ex, f))
    finally:
        ex._mesh_count = own
    return {k: {"p50_of_rounds": statistics.median(v), "rounds": v} for k, v in out.items()}


def ab_http(device, seed, rounds=2, plans_order=None, count_load=(QPS_CONNS, QPS_PER_CONN),
            mixed_load=(QPS_CONNS, QPS_PER_CONN)):
    """The http phase's QPS loops through the checkout's node, on a holder
    and engine of its own: b10m (10 shards, 128 rows) with v10,
    ``serve`` on the async backend, the memo off; per round
    http_count_e2e_p50, http_count_qps (``count_load``: connections x c2
    Counts each) and http_mixed_qps (Count, Count, TopN, Sum), every reply
    exact.  ``plans_order`` (a list of (plans, frozen, heat) triples) sets
    the query-plan layer and the heat feed on or off for each round in
    turn, where the checkout has them, and with ``frozen`` moves every
    object alive before the
    round out of the collector's reach (``gc.freeze``) for it; each round
    also gives its Count loop's serving-thread CPU microseconds per query
    (``_thread_cpu_s``) and cyclic-GC collections and time (``_GcMeter``)."""
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.core.view import VIEW_STANDARD
    from pilosa_tpu_torch.net.admission import AdmissionController
    from pilosa_tpu_torch.net.server import serve
    from pilosa_tpu_torch.parallel.engine import TorchEngine

    rng = np.random.default_rng(seed + 30)
    holder = Holder(device=device)
    engine = TorchEngine(holder, device=device)
    words = {r: rng.integers(0, 1 << 64, (N_SHARDS_10M, W64), dtype=np.uint64) for r in F10_ROWS}
    idx = holder.create_index("b10m")
    view = idx.create_field("f").view_if_not_exists(VIEW_STANDARD)
    for sh in range(N_SHARDS_10M):
        frag = view.fragment_if_not_exists(sh)
        for r in F10_ROWS:
            frag.load_row_words(r, words[r][sh])
        frag.cache.invalidate()
    v10 = idx.create_field("v10", FieldOptions(type="int", min=0, max=(1 << BSI_DEPTH) - 1))
    planes = {p: rng.integers(0, 1 << 64, (N_SHARDS_10M, W64), dtype=np.uint64)
              for p in range(BSI_DEPTH)}
    planes[BSI_DEPTH] = np.full((N_SHARDS_10M, W64), (1 << 64) - 1, dtype=np.uint64)
    for sh in range(N_SHARDS_10M):
        frag = v10.view_if_not_exists("bsig_v10").fragment_if_not_exists(sh)
        for p, w in planes.items():
            frag.load_row_words(p, w[sh])
        frag.cache.invalidate()
    sum_want = [{"value": sum((1 << p) * int(popcounts(planes[p]).sum()) for p in range(BSI_DEPTH)),
                 "count": N_SHARDS_10M << 20}]
    texts, wants = c2_queries(words)
    top10 = TopNOracle(words)
    mixed_texts, mixed_wants = [], []
    for k in range(len(F10_ROWS) // 4):
        a = 100 + 4 * k
        for j in (k, (k + 7) % len(texts)):
            mixed_texts.append(texts[j])
            mixed_wants.append(wants[j])
        mixed_texts.append(f"TopN(f, Row(f={a}), n=5)")
        mixed_wants.append([[{"id": r, "count": c} for r, c in top10.fused(words[a], 5)]])
        mixed_texts.append("Sum(field=v10)")
        mixed_wants.append(sum_want)
    srv, _ = serve(API(holder=holder, engine=engine), "localhost", 0,
                   admission=AdmissionController(max_inflight=1 << 17))
    port = srv.server_address[1]
    out = {}
    try:
        with memo_off(engine):
            for t, w in zip(mixed_texts[:8], mixed_wants[:8]):
                _http_results(port, "b10m", t, w, t)
            run_qps(port, texts, wants, 64, 8)
            run_qps(port, mixed_texts, mixed_wants, 64, 8)
            for r in range(rounds):
                frozen = False
                if plans_order:
                    on, frozen, heat = plans_order[r % len(plans_order)]
                    out.setdefault("plans", []).append(_set_plans(on))
                    out.setdefault("heat", []).append(_set_heat(heat))
                    out.setdefault("gc_frozen", []).append(frozen)
                if frozen:
                    gc.collect()
                    gc.freeze()
                out.setdefault("http_count_e2e_p50", []).append(_seq_p50(port, texts, wants))
                c0 = _thread_cpu_s()
                with _GcMeter() as meter:
                    qps, n = run_qps(port, texts, wants, *count_load)
                c1 = _thread_cpu_s()
                out.setdefault("http_count_qps", []).append(qps)
                out.setdefault("thread_cpu_us_per_query", []).append(
                    {k: round((c1[k] - c0.get(k, 0.0)) / n * 1e6, 2) for k in c1
                     if c1[k] > c0.get(k, 0.0)})
                out.setdefault("gc_per_count_loop", []).append(
                    {"collections": meter.collections, "us_per_query": meter.seconds / n * 1e6})
                out.setdefault("http_mixed_qps", []).append(
                    run_qps(port, mixed_texts, mixed_wants, *mixed_load)[0])
                if frozen:
                    gc.unfreeze()
    finally:
        srv.shutdown()
        engine.close()
        _set_plans(True)
        _set_heat(True)
    return out


class _GcMeter:
    """The cyclic garbage collector's collections (per generation) and
    seconds while the block runs, from ``gc.callbacks``: a collection
    holds the GIL, so its time is taken from every serving thread."""

    def __init__(self):
        self.collections, self.seconds, self._t = [0, 0, 0], 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.collections[info["generation"]] += 1
            self.seconds += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)
        return False


def _thread_cpu_s():
    """CPU seconds of this process's threads, summed per kind (the name
    without its number: ``http-reactor``, ``count-batch-drain``,
    ``count-batch-dispatch``, ``count-batch-collect``, ...), from
    /proc/self/task."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for t in threading.enumerate():
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, TypeError):
            continue
        kind = t.name.rstrip("0123456789-_")
        out[kind] = out.get(kind, 0.0) + (int(fields[11]) + int(fields[12])) / tick
    return out


def _set_plans(on):
    """The query-plan layer on or off (``util/plans.py ENABLED``, what
    ``PILOSA_PLANS=0`` sets at import); None for a checkout from before
    the plans."""
    try:
        from pilosa_tpu_torch.util import plans
    except ImportError:
        return None
    plans.ENABLED = bool(on)
    return plans.ENABLED


def _set_heat(on):
    """The heat feed on or off (``HEAT.enabled``, what ``PILOSA_HEAT=0``
    sets at import; heat feeds the miner and the advisor, so all three);
    None for a checkout from before heat."""
    try:
        from pilosa_tpu_torch.util.heat import HEAT
    except ImportError:
        return None
    HEAT.enabled = bool(on)
    return HEAT.enabled


def run_serving_ab(root, seed, order):
    """``--root DIR --serving ORDER``: the serving numbers alone, for many
    short alternating calls: the lone dense and sparse Count p50s
    (``count_p50_ms`` over bench's 960 shards, as ``--root`` gives them)
    and the http loops (``ab_http`` at 640 connections x 16 c2 Counts and
    640 x 8 mixed queries), one round for each entry of ORDER (``on`` or
    ``off``: the query-plan layer; ``-noheat`` after it: the heat feed
    off; ``-frozen``: the http round with ``gc.freeze``), with each round's
    serving-thread CPU and GC time per query.  One JSON line."""
    import torch

    import pilosa_tpu_torch
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.parallel import build
    from pilosa_tpu_torch.parallel.engine import TorchEngine

    pkg = os.path.dirname(os.path.abspath(pilosa_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise AssertionError(f"imported {pkg}, not the package under {root}")
    plans_order = [(x.split("-")[0] == "on", "frozen" in x.split("-")[1:],
                    "noheat" not in x.split("-")[1:]) for x in order.split(",")]
    build.build(build.KERNELS)
    device = torch.device("cuda")
    holder = Holder(device=device)
    build_index(holder, N_SHARDS, seed)
    engine = TorchEngine(holder, device=device)
    ex = Executor(holder, engine=engine)
    for field in ("f", "s"):
        engine.field_stack("bench", field, "standard")
        for k in range(12):
            ex.execute("bench", pql_of(field, "and", (10 + 2 * k, 11 + 2 * k)))
    out = {"root": root, "plans": [], "heat": [], "dense_count_p50_ms": [],
           "sparse_count_p50_ms": []}
    with memo_off(engine):
        for on, _, heat in plans_order:
            out["plans"].append(_set_plans(on))
            out["heat"].append(_set_heat(heat))
            out["dense_count_p50_ms"].append(count_p50_ms(ex, "f"))
            out["sparse_count_p50_ms"].append(count_p50_ms(ex, "s"))
    _set_plans(True)
    _set_heat(True)
    engine.close()
    out["http"] = ab_http(device, seed, rounds=len(plans_order), plans_order=plans_order,
                          count_load=(QPS_CONNS, 16), mixed_load=(QPS_CONNS, 8))
    out["card"] = card_line()
    print(json.dumps(out), flush=True)


def ab_k1_kr(engine, holder, seed):
    """--root's launch-bound items: K1 at the main path's shape (the 12
    pairs of f in turn over 960 shards) and the range leaf KR (K1 over
    Range(v > 100), bench.py's v of depth 8), then K6 and K7 over v
    unfiltered (Sum, Min), each as ``measured`` gives
    it: CUDA-event ms around 10 wrapper calls, device ms per launch, host
    us per call.  Made through the checkout's engine, so that a change to
    the launch's parameters or to the kernels' variants shows."""
    import torch

    from pilosa_tpu_torch import pql
    from pilosa_tpu_torch.parallel import bsi, kernels
    from pilosa_tpu_torch.parallel.engine import _Lowering

    sync = torch.cuda.synchronize
    canonical = engine.canonical_shards("bench")
    S = len(canonical)
    lw = _Lowering(engine, canonical)
    codes = [kernels.compile_prog(engine._lower("bench", pql.parse(
        f"Intersect(Row(f={10 + 2 * k}), Row(f={11 + 2 * k}))").calls[0], lw)) for k in range(12)]
    mask = engine._mask_words(canonical, canonical)
    it = iter(range(10 ** 9))
    for _ in range(5):
        kernels.count_tree_dense(codes[0], lw.mats, mask)
    sync()
    out = {"k1": measured(lambda: kernels.count_tree_dense(codes[next(it) % 12], lw.mats, mask),
                          "count_tree_dense_kernel", sync,
                          bound_ms=2 * S * W64 * 8 / HBM_BYTES_PER_S * 1e3)}
    # The launch alone: K1's C entry with its arguments made once, so that
    # the host time of the launch (the parameters packed and sent) shows
    # apart from the wrapper's Python.
    fn = kernels._lib_fn("count_tree_dense", "count_tree_dense",
                         kernels._TREE_ARGS + [kernels._P, kernels._I, kernels._I, kernels._P,
                                               kernels._P])
    res = torch.zeros(1, dtype=torch.int64, device=mask.device)
    args = (kernels._c_leaves(codes[0], lw.mats) + (mask.data_ptr(), S, 32768, res.data_ptr(),
                                                    torch.cuda.current_stream().cuda_stream))
    out["k1_launch_host_us"] = host_us(lambda: fn(*args), sync)
    # K1 where the launch is the cost: two rows over 16 shards.
    small = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 16, 32768), dtype=torch.int32,
                          device=mask.device)
    mask16 = torch.ones(16, dtype=torch.int32, device=mask.device)
    code16 = kernels.compile_prog(("and", ("row", 0, 0), ("row", 0, 1)))
    out["k1_16_shards"] = measured(lambda: kernels.count_tree_dense(code16, [small], mask16),
                                   "count_tree_dense_kernel", sync)
    out["threads"] = sorted(t.name for t in threading.enumerate())
    build_bsi_fields(holder, S, seed)
    engine.field_stack("bench", "v", "bsig_v")
    lw = _Lowering(engine, canonical)
    rprog = engine._lower("bench", pql.parse("Range(v > 100)").calls[0], lw)
    got, want = kernels.count_tree(rprog, lw.mats, mask), kernels.count_tree_plain(rprog, lw.mats,
                                                                                  mask)
    if int(got) != int(want):
        raise AssertionError(f"KR: {int(got)} != plain {int(want)}")
    for _ in range(3):
        kernels.count_tree(rprog, lw.mats, mask)
    sync()
    out["kr"] = measured(lambda: kernels.count_tree(rprog, lw.mats, mask),
                         "count_tree_dense_kernel", sync,
                         bound_ms=(BSI_DEPTH + 1) * S * W64 * 8 / HBM_BYTES_PER_S * 1e3)
    # K6 at the bsi phase's shape: Sum(field=v), no filter.
    vst = engine.field_stack("bench", "v", "bsig_v", canonical)
    vplanes = engine._plane_spec(vst, BSI_DEPTH)
    for _ in range(3):
        bsi.sum_tree(None, [], mask, vst.matrix, vplanes)
    sync()
    out["k6"] = measured(lambda: bsi.sum_tree(None, [], mask, vst.matrix, vplanes),
                         "sum_tree_kernel", sync,
                         bound_ms=(BSI_DEPTH + 1) * S * W64 * 8 / HBM_BYTES_PER_S * 1e3)
    # K7 at the same shape: Min(field=v), no filter.
    for _ in range(3):
        bsi.minmax_tree(None, [], mask, vst.matrix, vplanes, True)
    sync()
    out["k7"] = measured(lambda: bsi.minmax_tree(None, [], mask, vst.matrix, vplanes, True),
                         "minmax_tree_kernel", sync,
                         bound_ms=(BSI_DEPTH + 1) * S * W64 * 8 / HBM_BYTES_PER_S * 1e3)
    return out


def ab_pool(device, seed):
    """--root's pool items, on tensors made here from the seed at the
    residency sweep's shape (960 shards, rows in 8 of the 64 blocks): a
    block pool of 4 rows, 4 candidate rows and an 8-plane BSI stack (7
    value planes and not-null) with words in those blocks only.  K1P over
    the Intersect of two pool rows (kernels.count_tree), the full TopN of
    the 4 candidates against one pool row (kernels.topn_full_tree, n = 3),
    and the Sum under the Intersect of two pool rows (bsi.sum_tree): each
    through the checkout's wrapper, so that K3P and K6P show where the
    checkout has them and K3's and K6's whole-row walk where it has not.
    Each against its plain version; device ms per call (torch.profiler).
    Then F1 over dense rows, device ms per launch."""
    import torch

    from pilosa_tpu_torch.parallel import bsi, kernels

    sync = torch.cuda.synchronize
    gen = torch.Generator(device=device).manual_seed(seed + 14)
    S, W, live = N_SHARDS, 32768, RSW_BLOCKS * 512

    def rand(shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32, device=device,
                             generator=gen)

    pool = rand((1 + 4 * RSW_BLOCKS, S, 512))
    pool[0] = 0
    table = torch.zeros((4, 64), dtype=torch.int32, device=device)
    table[:, :RSW_BLOCKS] = 1 + torch.arange(4 * RSW_BLOCKS, dtype=torch.int32,
                                             device=device).reshape(4, RSW_BLOCKS)
    cand = torch.zeros((4, S, W), dtype=torch.int32, device=device)
    cand[:, :, :live] = rand((4, S, live))
    bst = torch.zeros((8, S, W), dtype=torch.int32, device=device)
    bst[:, :, :live] = rand((8, S, live))
    mats = [pool, table]
    mask = torch.ones(S, dtype=torch.int32, device=device)
    rb = [("rowb", 0, 1, r) for r in range(4)]
    seg = ("and", rb[0], rb[1])
    idx = torch.tensor([0, 1, 2, 3, 0, 0, 0, 0], dtype=torch.int32, device=device)
    cnt = torch.zeros((8, S), dtype=torch.int32, device=device)
    cnt[:4] = 1 << 17
    planes = tuple(range(8))
    calls = {
        "k1p": (lambda: kernels.count_tree(seg, mats, mask),
                lambda: kernels.count_tree_plain(seg, mats, mask), "count_tree_pool"),
        "k3_pool_src": (lambda: kernels.topn_full_tree(rb[2], mats, mask, cand, idx, cnt, 1, 3),
                        lambda: torch.stack(kernels.topn_full_tree_plain(
                            rb[2], mats, mask, cand, idx, cnt, 1, 3)), "score_rows"),
        "k6_pool_filter": (lambda: bsi.sum_tree(seg, mats, mask, bst, planes),
                           lambda: bsi.sum_tree_plain(seg, mats, mask, bst, planes), "sum_tree"),
    }
    out = {}
    for name, (fn, plain, kernel) in calls.items():
        _exact(name, fn().reshape(-1), plain().reshape(-1), "in --root")
        for _ in range(3):
            fn()
        sync()
        out[name] = device_ms(fn, kernel, per_call=True)
    # F1 over dense rows: the residency drain's slot table over 3 stack rows
    # of random words, writing 2 slots.
    rows = rand((3, S, W))
    dslots = (("and", ("row", 0, 0), ("row", 0, 1)), ("or", ("mref", 0), ("row", 0, 2)),
              ("row", 0, 2))
    dcode = kernels.compile_fused(dslots, frozenset((0, 1, 2)))
    fn = lambda: kernels.fused_tree_cuda(dcode, [rows], [0, 1], [mask, mask], [0, 2])  # noqa: E731
    fn()
    sync()
    out["f1_dense"] = device_ms(fn, "fused_tree_kernel",
                                bound_ms=5 * S * W * 4 / HBM_BYTES_PER_S * 1e3)
    return out


def ab_residency(device):
    """--root's residency items, through the checkout's engine: the
    residency phase's index and budget (build_rsw at 960 shards, 4x
    oversubscribed), the 8-Count query's and the drain's rows promoted by a
    cold pass; then the drain's fused_many p50, the 8-Count query's and the
    lone Min's and GroupBy's Executor.execute p50 (each answer against
    numpy, memo off), and every kernel of one call of each
    (call_kernels_ms): F1P, K6P, K3P, K7P, K8P and K5P where the checkout
    has them, F1, K6, K3, K7, K8 and K5 where not."""
    import gc

    import torch

    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.parallel.engine import TorchEngine
    from pilosa_tpu_torch.parallel.errors import ResidencyMiss

    t0 = time.perf_counter()
    holder = Holder(device=device)
    holder.open()
    words, (vcols, vvals) = build_rsw(holder, N_SHARDS)
    q8, want8, seg, entries, want_drain, lone = rsw_queries(words, vcols, vvals)
    budget = RSW_FIELDS * RSW_ROWS * N_SHARDS * ROW_SHARD_BYTES // 4 - N_SHARDS * ROW_SHARD_BYTES
    eng = TorchEngine(holder, device=device, max_resident_bytes=budget)
    eng.result_memo.maxsize = 0
    ex = Executor(holder, engine=eng)

    def eight():
        if ex.execute("rsw", q8).results != want8:
            raise AssertionError("--root residency: the 8 Counts disagree with numpy")

    def drain():
        got = eng.fused_many("rsw", entries)
        if drain_plain(got) != want_drain:
            raise AssertionError(f"--root residency: drain {got} != numpy {want_drain}")

    eight()  # cold: the host lane, the rows requested
    for _ in range(3):
        assert eng.residency.flush(300.0)
        try:
            drain()
            break
        except ResidencyMiss:
            pass
    else:
        raise AssertionError("--root residency: the drain missed three times")
    fb = eng.host_fallbacks
    eight()
    if eng.host_fallbacks != fb:
        raise AssertionError("--root residency: the warm 8-Count query fell back to the host")
    q_min, _, q_group = lone

    def one(q):
        got = _pql_result(ex.execute("rsw", q).results[0])
        if got != lone[q]:
            raise AssertionError(f"--root residency: {q} {got} != numpy {lone[q]}")

    out = {"set_up_s": time.perf_counter() - t0}
    for name, fn in (("drain_e2e_p50_ms", drain), ("eight_counts_e2e_p50_ms", eight),
                     ("min_e2e_p50_ms", lambda: one(q_min)),
                     ("groupby_e2e_p50_ms", lambda: one(q_group))):
        times = []
        for _ in range(RSW_WARM_REPS):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(times)
    out["drain_kernels"] = call_kernels_ms(drain, ("fused_tree", "sum_tree", "score_rows",
                                                   "minmax_tree", "groupn_tree"))
    out["eight_counts_kernels"] = call_kernels_ms(eight, ("count_batch_tree",))
    out["min_kernels"] = call_kernels_ms(lambda: one(q_min), ("minmax_tree",))
    out["groupby_kernels"] = call_kernels_ms(lambda: one(q_group), ("groupn_tree",))
    eng.close()
    holder.close()
    del eng, ex, holder, words
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ab_kernels(device, seed):
    """--root's kernel items, on tensors made here from the seed, through
    the checkout's wrappers (their signatures unchanged since K8 came): K3's
    full TopN at the main path's K = 16 over 960 shards and at K = 4096
    (16 shards, 512 distinct rows named by index), copying the totals out
    and trimming to 5 (and to 4096), so that the trim's share shows; K8
    at the groupby phase's 8-way, 3-field, filtered and 4 x 2 x 16 shapes
    over 960 shards and at 32 x 32 over 96 (the last two: the walk).
    Device ms per call over K3's kernels, per launch for K8
    (torch.profiler; a K8 reading below its bound is taken again)."""
    import torch

    from pilosa_tpu_torch.parallel import groupby, kernels

    sync = torch.cuda.synchronize
    gen = torch.Generator(device=device).manual_seed(seed)
    W = 32768

    def rand_and(shape, n):
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32, device=device,
                          generator=gen)
        for _ in range(n - 1):
            x &= torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32, device=device,
                               generator=gen)
        return x

    out = {}
    code = kernels.compile_prog(("row", 0, 0))
    for R, S, K, n_and, n_outs in ((16, N_SHARDS, 16, 2, (None, 5)),
                                   (WIDE_BASE, 16, kernels.TOTALS_MAX, 3, (None, 5, 4096))):
        cand = rand_and((R, S, W), n_and)
        src = rand_and((1, S, W), 1)
        idx = (torch.arange(K, device=device, dtype=torch.int32) % R).contiguous()
        cnt = torch.full((K, S), 1 << 17, dtype=torch.int32, device=device)
        mask = torch.ones(S, dtype=torch.int32, device=device)
        for n_out in n_outs:
            fn = lambda n_out=n_out: kernels.score_rows_cuda(  # noqa: E731
                code, [src], mask, cand, idx, scores=False, cnt=cnt, n_out=n_out)
            fn()
            sync()
            key = f"k3_K{K}_n_out_{n_out}" if K != 16 else f"k3_K16_S{S}_n_out_{n_out}"
            out[key] = device_ms(fn, "score_rows", per_call=True)
        del cand, src
    S = N_SHARDS
    g = {name: rand_and((n, S, W), 2) for name, n in GROUP_ROWS.items()}
    frow = rand_and((1, S, W), 1)
    mask = torch.ones(S, dtype=torch.int32, device=device)
    shapes = {"8-way": (("ga", "gb"), None), "3-field": (("ga", "gb", "gc"), None),
              "8-way, filter": (("ga", "gb"), code), "4x2x16": (("ga", "gb", "top"), None)}
    for name, (fields, filt) in shapes.items():
        fm = [g[f] for f in fields]
        li = [list(range(GROUP_ROWS[f])) for f in fields]
        fn = lambda fm=fm, li=li, filt=filt: groupby.groupn_tree_cuda(  # noqa: E731
            filt, [frow], mask, fm, li)
        fn()
        sync()
        bound = k8_work([GROUP_ROWS[f] for f in fields], filt is not None, S)[2]
        out[f"k8_{name}"] = device_ms(fn, "groupn_tree_kernel", bound_ms=bound)
    del g, frow
    S = 96
    big = rand_and((32, S, W), 2)
    mask = torch.ones(S, dtype=torch.int32, device=device)
    fn = lambda: groupby.groupn_tree_cuda(None, [], mask, [big, big],  # noqa: E731
                                          [list(range(32)), list(range(32))])
    fn()
    sync()
    out["k8_32x32_96_shards"] = device_ms(fn, "groupn_tree_kernel",
                                          bound_ms=k8_work([32, 32], False, S)[2])
    return out


def ab_stream(engine, ex, host, seed, threads=64, per_thread=32):
    """--root's serve item: the serve phase's concurrent execute_async
    stream (memo off), its answers against numpy: queries/s, p50, batches
    and the kernels they launched."""
    want = expected_counts(host)
    b = engine.batcher()
    b0, q0 = b.batches, b.batched_queries
    _zero_launches()
    with memo_off(engine):
        wall, lat = _stream(ex, sorted(want), want, threads, per_thread, seed)
    n = threads * per_thread
    return {"qps": n / wall, "p50_ms": statistics.median(lat),
            "p99_ms": float(np.percentile(lat, 99)), "batches": b.batches - b0,
            "mean_batch": (b.batched_queries - q0) / max(1, b.batches - b0),
            "launches": _launch_counts(), "fallbacks": ex.async_fallbacks}


def compare_sass(parent):
    """--sass: every kernel library of this checkout and of ``parent``
    built with the build's flags (one nvcc each, all at once, into
    build/sass/), and each parent function's SASS compared with the
    function of the same name here (cuobjdump -sass, the
    anonymous-namespace hash and the addresses stripped).  Prints one JSON
    line: per library, the parent's functions, how many are identical, the
    names of those that differ or are missing, and how many are new."""
    import re

    from pilosa_tpu_torch.parallel import build

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sass")
    os.makedirs(out_dir, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    procs = {}
    for tag, root in (("change", str(build.CSRC.parents[1])), ("parent", parent)):
        for name in build.KERNELS:
            src = os.path.join(root, "pilosa_tpu_torch", "csrc", f"{name}.cu")
            if os.path.exists(src):
                lib = os.path.join(out_dir, f"{tag}-{name}.so")
                procs[(tag, name)] = (lib, subprocess.Popen(
                    [build.nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for (tag, name), (_, proc) in procs.items():
        log_, _ = proc.communicate()
        if proc.returncode:
            raise AssertionError(f"sass: nvcc failed on {tag} {name}:\n{log_[-3000:]}")

    def funcs(lib):
        txt = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                             check=True).stdout
        out, name = {}, None
        for line in txt.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1))
                out[name] = []
            elif name:
                out[name].append(re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "",
                                        line).strip())
        return out

    result = {}
    for name in build.KERNELS:
        if ("parent", name) not in procs:
            continue
        a, b = funcs(procs[("parent", name)][0]), funcs(procs[("change", name)][0])
        result[name] = {"parent_functions": len(a),
                        "identical": sum(1 for k in a if b.get(k) == a[k]),
                        "differ": sorted(k for k in a if k in b and b[k] != a[k]),
                        "missing": sorted(k for k in a if k not in b),
                        "new": len(set(b) - set(a))}
    print(json.dumps({"sass": result}), flush=True)


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
    ap.add_argument("--check-only", action="store_true",
                    help="build the kernels and run phase 2 (kernels against their plain "
                         "versions) only; prints no result line")
    ap.add_argument("--root", help="A/B mode: import pilosa_tpu_torch from this checkout, print "
                                   "its end-to-end numbers and main-path kernels as one JSON "
                                   "line, and stop; prints no result line")
    ap.add_argument("--serving", metavar="ORDER",
                    help="with --root: only the lone Count p50s and the http loops, one round "
                         "per entry of ORDER (on,off,...: the query-plan layer); one JSON line")
    ap.add_argument("--sass", metavar="PARENT",
                    help="build every kernel library of this checkout and of PARENT and "
                         "compare each function's SASS; prints one JSON line and stops")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        from pilosa_tpu_torch.parallel import build
    except ImportError as e:
        print(f"chip_smoke: pilosa_tpu_torch not found under {root}: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    n_int, n_popc = card_rates()
    log(f"rates: {n_int:.4g} integer operations and {n_popc:.4g} popcounts a second "
        "(the card's SMs at its maximum SM clock)")
    if args.root and args.serving:
        run_serving_ab(root, args.seed, args.serving)
        return 0
    if args.root:
        run_ab(root, args.seed)
        return 0
    if args.sass:
        compare_sass(os.path.abspath(args.sass))
        return 0

    t0 = time.perf_counter()
    built = build.build(build.KERNELS)
    log(f"build: {time.perf_counter() - t0:.3f} s "
        f"({', '.join(f'{k} {v:.3f} s' for k, v in built.items()) or 'cached'})")

    from pilosa_tpu_torch import native

    libs = {"roaring_codec": native.load(), "sparse_merge": native.load_merge()}
    if any(lib is None for lib in libs.values()):
        raise AssertionError(f"native: a host library did not build or load: {libs}")
    log("native: both host libraries loaded (" + ", ".join(
        f"{k} {native.lib_path(k).relative_to(root)}" for k in libs) + ")")

    err = check_kernels(device, args.seed)
    err.update(check_topn_kernels(device, args.seed))
    err.update(check_topn_slab(device, args.seed))
    err.update(check_batch_kernel(device, args.seed))
    err.update(check_bsi_kernels(device, args.seed))
    err.update(check_batch_ranges(device, args.seed))
    err.update(check_groupby_kernel(device, args.seed))
    err.update(check_fused_kernel(device, args.seed))
    err.update(check_pool_leaf(device, args.seed))
    err["minmax_tree_pool"] = max(err.get("minmax_tree_pool", 0),
                                  check_minmax_pool(device, args.seed)["minmax_tree_pool"])
    err["eval_tree"] = check_eval_tree(device, args.seed)
    err["score_rows_trim"] = check_trim_alone(device, args.seed)
    if args.check_only:
        log(f"check-only: every kernel exact against its plain version: {err}")
        return 0
    timeline, t_mark = {"build_and_checks": time.perf_counter() - t0}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        timeline[name] = now - t_mark[0]
        t_mark[0] = now

    # Host only, before any phase's threads start.
    log("native: " + json.dumps(run_native_ab(args.seed)))
    mark("native")

    holder, engine, ex, host, launches = run_main_path(device, N_SHARDS, args.seed)
    topn_launches, engine_less_query = run_topn_main_path(device, holder, engine, ex, host)
    launches.update(topn_launches)
    wide_launches, wide_out = run_wide_topn(device, holder, engine, ex, args.seed)
    log("wide: " + json.dumps(wide_out))
    for k, v in wide_launches.items():
        launches[k] += v
    for v in launches.values():
        if v <= 0:
            raise AssertionError(f"a kernel of the main path never launched: {launches}")
    mark("main_path")
    kern = time_kernels(engine, ex, device, err, launches)
    kern += time_topn(engine, ex, holder, device, err, launches)
    rows_f = time_batch_f(engine, device, err, args.seed)
    k10_times = time_eval_tree(engine, device, err)
    trim_times = time_trim_alone(device)
    # After the timing windows, so that no profiler session precedes them.
    engine_less_kernels(holder, *engine_less_query)
    q = "TopN(top, Row(f=10), n=5)"
    engine_topn_kernels(ex, q, TopNOracle(host["top"]).fused(host["f"][10], 5))
    mark("kernel_times")
    serve, k5_launches, b10m_row = run_serve_path(device, holder, engine, ex, host, args.seed)
    log("serve: " + json.dumps(serve))
    kern.append(k5_entry(rows_f, b10m_row, k5_launches, err))
    mark("serve")
    bsi_out, bsi_entries = run_bsi_path(device, holder, engine, ex, host, args.seed, err)
    log("bsi: " + json.dumps(bsi_out))
    kern += bsi_entries
    if "k5_ranges" in bsi_out:
        k5 = next(e for e in kern if e["name"] == "count_batch_tree")
        k5["at"]["8 Count(Range(v > x)) on v"] = bsi_out["k5_ranges"]
        k5["at"]["16 range conditions on v"] = bsi_out["k5_ranges_16"]
    mark("bsi")
    group_out, group_entry = run_groupby_path(device, holder, engine, ex, host, args.seed, err)
    log("groupby: " + json.dumps(group_out))
    kern.append(group_entry)
    mark("groupby")
    log("api: " + json.dumps(run_api_path(device, holder, engine, ex, host, args.seed)))
    mark("api")
    fusion_out, fusion_entry = run_fusion_path(device, holder, engine, ex, args.seed, err)
    log("fusion: " + json.dumps(fusion_out))
    kern.append(fusion_entry)
    mark("fusion")
    log("http: " + json.dumps(run_http_path(device, holder, engine, host, args.seed)))
    mark("http")
    procmode = run_procmode_path(device, holder, engine, host, args.seed)
    log("procmode: " + json.dumps(procmode))
    mark("procmode")
    keep = {}
    res_out, res_launches, (t_rowb, plain_rowb, rowb_bytes), k1p, aggs = run_residency_path(
        device, args.seed, keep=keep)
    log("residency: " + json.dumps(res_out))
    # rowb: the pool leaf inside the kernels, timed in K1 over the same
    # pool rows as K1P (which replaced it on the Count path).
    kern.append(_entry("rowb", "pilosa_tpu_torch/csrc/tree_eval.cuh",
                       "pilosa_tpu/parallel/kernels.py:84", res_launches, err["rowb"], t_rowb,
                       plain_rowb, rowb_bytes, rowb_bytes // 4 * 2, None))
    k1p_launches, t_k1p, plain_k1p, k1p_bytes = k1p
    kern.append(_entry("count_tree_pool", "pilosa_tpu_torch/csrc/count_tree_pool.cu",
                       "pilosa_tpu/parallel/kernels.py:84", k1p_launches, err["count_tree_pool"],
                       t_k1p, plain_k1p, k1p_bytes, k1p_bytes // 4 * 2, None))
    # K3P, K6P, K7P, K8P, K5P and F1P on the residency phase's TopN, Sum,
    # Min, GroupBy, 8-Count query and drain over pool rows: an AND, a
    # popcount and an add per word read (K7P: six per plane word, as K7).
    for name, src, rep, (n_int, n_popc) in (
            ("score_rows_pool", "score_rows", "pilosa_tpu/parallel/kernels.py:346", (2, 1)),
            ("sum_tree_pool", "sum_tree", "pilosa_tpu/parallel/kernels.py:475", (2, 1)),
            ("minmax_tree_pool", "minmax_tree", "pilosa_tpu/parallel/kernels.py:511", (6, 0)),
            ("groupn_tree_pool", "groupn_tree_pool", "pilosa_tpu/parallel/kernels.py:707", (2, 1)),
            ("count_batch_tree_pool", "count_batch_tree", "pilosa_tpu/parallel/kernels.py:255",
             (2, 1)),
            ("fused_tree_pool", "fused_tree", "pilosa_tpu/parallel/kernels.py:545", (2, 1))):
        n, t = aggs[name]
        words = t["bytes"] // 4
        kern.append(_entry(name, f"pilosa_tpu_torch/csrc/{src}.cu", rep, n, err[name], t,
                           t["plain_ms"], t["bytes"], (words * n_int, words * n_popc), None))
    mark("residency")
    observe = run_observe_path(device, args.seed, keep)
    log("observe: " + json.dumps(observe))
    mark("observe")
    repair = run_repair_path(device)
    log("repair: " + json.dumps(repair))
    mark("repair")
    # The mesh phase's data directories are written while the cluster's
    # nodes open theirs, their f and top files links to the cluster's.
    written = {}

    def write_mesh(files):
        shutil.rmtree(os.path.dirname(mesh_dirs()[0]), ignore_errors=True)
        t1 = time.perf_counter()
        write_mesh_dirs(holder, mesh_dirs(), N_SHARDS, files)
        written["s"] = time.perf_counter() - t1

    cluster, k9_entry = run_cluster_path(device, holder, engine, host, args.seed, err,
                                         while_starting=write_mesh)
    log("cluster: " + json.dumps(cluster))
    kern.append(k9_entry)
    mark("cluster")
    mesh = run_mesh_path(device, holder, host, args.seed, err, cluster, written_s=written["s"])
    log("mesh: " + json.dumps(mesh))
    # K10 and the trim alone run on the mesh's ranks only: their launches
    # are the nodes', timed at the phase's shapes in this process.
    for name, src, rep, times, main_at, other in (
            ("eval_tree", "eval_tree", "pilosa_tpu/parallel/kernels.py:284", k10_times,
             N_SHARDS, f"{N_SHARDS // 2} shards (a rank's block)"),
            ("score_rows_trim", "score_rows", "pilosa_tpu/parallel/kernels.py:356", trim_times,
             16, "K = 4096")):
        t, plain, library, byts, ops = times[main_at]
        entry = _entry(name, f"pilosa_tpu_torch/csrc/{src}.cu", rep,
                       sum(v["launches"][name] for v in mesh["nodes"].values()),
                       err[name], t, plain, byts, ops, library)
        t, plain, library, byts, ops = next(v for k, v in times.items() if k != main_at)
        entry["at"] = {other: {"ms": t["ms"], "device_ms": t["device_ms"],
                               "host_us": t["host_us"], "plain_ms": plain,
                               "library_ms": library, "bound_ms": least_ms(byts, ops)}}
        entry["mesh_launches"] = {k: v["launches"][name] for k, v in mesh["nodes"].items()}
        kern.append(entry)
    mark("mesh")
    # Last: it writes the index every phase above read.
    log("write: " + json.dumps(run_write_path(device, holder, engine, ex, host, args.seed)))
    mark("write")
    for entry in kern:  # the later paths' launches beside the main path's
        entry["procmode_launches"] = procmode["launches"][entry["name"]]
        entry["observe_launches"] = observe["launches"][entry["name"]]
        entry["repair_launches"] = repair["launches"][entry["name"]]
    log("timeline (s): " + json.dumps({k: round(v, 3) for k, v in timeline.items()})
        + f"; total {time.perf_counter() - t0:.3f} s")
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
