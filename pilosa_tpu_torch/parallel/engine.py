"""TorchEngine: fused Count(tree), TopN, BSI Sum/Min/Max and GroupBy over
device-resident field stacks.

The port of the Count, TopN, BSI and GroupBy slices of
``pilosa_tpu/parallel/engine.py`` (``MeshEngine``).  Per Count query:

1. the call tree is lowered to a normalized program over a list of field
   stacks ``int32[R, S, WORDS]`` — S the index's canonical shard axis,
   R the view's row table — with row indices as plain integers; a BSI
   ``Range`` condition is one range leaf over its ``bsig_<field>`` stack's
   planes, and a time-quantum ``Range`` the OR of one row leaf per view
   of the minimal view cover;
2. ``_sparse_plan`` combines the stacks' exact block-occupancy summaries
   through the tree on the host; when at most ``sparse_threshold`` of the
   requested blocks survive, the count runs on K2 (``sparse.py``) over
   only those blocks, named by one uint64 word per shard, else on K1
   (``kernels.py``) over every word;
3. the kernel reduces on the device and the result is one int64.

TopN (``topn_full``): the candidates are the id-descending union of the
fragments' ranked caches, cached per (index, field) against the stack's
token with their per-shard store counts; K3 scores every candidate
against the masked src tree by index into the resident stack, gates each
(candidate, shard) and sums the totals, and the launch's last block trims
them to the top n: one launch and one readback.
``topn_scores`` is the two-phase lane's phase 1 (scores and src counts of
every shard in one K3 launch) and ``topn_cache_only`` the no-src TopN,
reduced on the host.

Field stacks are cached per (index, field, view) over the canonical shard
list, so queries over different shard subsets share one resident stack;
the requested subset is a per-shard mask.  When a view's version moves,
the stack syncs in place (``_try_incremental_sync``, ``stack_updates``):
each fragment's ``sync_snapshot`` names the rows and words written since
the stack's sync point, and only those are scattered into the resident
tensor, with the exact block occupancy beside them.  A stack is rebuilt
whole (``stack_rebuilds``) only when its shape or sources changed: a new
row, a replaced or removed fragment, a new shard axis, or a storage load
past the sync point.  ``IngestSyncer`` runs the same sync off the query
path after bulk imports.

BSI (``sum``, ``min_max``): the filter tree and the field's planes go to
one launch of K6 ``bsi.sum_tree`` (per-plane counts, summed on the host in
Python ints) or K7 ``bsi.minmax_tree`` (per-shard extreme and count,
reduced on the host).

GroupBy (``group_counts``): the group fields' stacks, their listed rows by
index and the lowered filter go to one launch of K8 ``groupby.groupn_tree``
(every combination's count, row-major); past MAX_GROUP_COMBOS
combinations the executor's host iterator serves the call.

Serving (``count_many``, the result memo, ``batcher()``): K Counts run as
one K5 launch (``kernels.count_batch_tree``, range leaves included) with
one readback; identical
(query, shard set) entries of a batch are evaluated once and fanned back
out; a batch that dedups to one query takes the scalar path above (K1, or
K2 through the sparse plan).  The result memo answers a repeat of a
(query, shard set) against unchanged views with no launch at all: its key
carries the version token of every view the tree reads, so a write
re-keys its readers.  ``CountBatcher`` (``batcher.py``) drains concurrent
Counts into ``count_many_async``.

Tiered residency (docs/residency.md; ``pilosa_tpu/parallel/engine.py``
:1092-1440, :1719-2160): the card is a working-set cache over the host
tier under ``max_resident_bytes``.  A full stack that fits is built as
above, after cost-priced eviction of other stacks makes room; one that
does not fit raises ``ResidencyMiss`` (the executor serves the query from
the host lane) and asks the ``ResidencyManager`` (``residency.py``) to
promote the rows the query touches (``_collect_row_hints``).  Its worker
(``_promote``) packs those rows' occupied 2 KiB blocks into a block pool
``int32[P, S, 512]`` whose slot 0 is all zero, one slot per (row, occupied
block); a row of it lowers to a pool leaf ``("rowb", pool, table, row)``
that the hand kernels read in place through the row's slot vector
(``csrc/tree_eval.cuh``), so the next query over the working set runs on
the card.  A query touching a row outside a partial stack misses and grows
the working set; aggregates (BSI planes, TopN candidates, GroupBy fields)
need full stacks (``_require_full_stack``).  Writes to a pool stack sync
in place as block writes (``_pool_sync_row``).

Whole-dashboard fusion (``fused_drain_async``, ``fusion.py``): a drain of
mixed Count/Sum/Min/Max/TopN/GroupBy items, possibly over several
indexes, is planned once per drain shape (``_fused_plan_for``, cached and
revalidated against the stacks' version tokens) and launched as one F1 per
index plus each aggregate edge's kernel, every distinct Row subtree
evaluated once.  The batcher's aggregate lane (``submit_op``) reaches it
through ``batched_sum``, ``batched_min_max``, ``batched_topn_scores``,
``batched_topn_full`` and ``batched_group_counts``; a lone caller runs the
op's own program (``solo_op``), and Sum/Min/Max/TopN ride the result memo
(``memo_probe_op``).
"""

from __future__ import annotations

import gc
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import timequantum
from ..core.cache import pair_sort_key
from ..core.index import EXISTENCE_FIELD_NAME
from ..core.view import VIEW_STANDARD, view_bsi_name
from ..ops import bitops
from ..pql import BETWEEN, EQ, GT, GTE, LT, LTE, NEQ, Call, Condition
from ..util import events as events_mod
from ..util import heat as heat_mod
from ..util import plans as plans_mod
from ..util.stats import (ENGINE_CACHES, METRIC_DEVICE_BYTES_SKIPPED,
                          METRIC_ENGINE_CACHE_HITS, METRIC_ENGINE_CACHE_MISSES,
                          METRIC_ENGINE_EVICTIONS, METRIC_ENGINE_PROMOTIONS,
                          METRIC_ENGINE_RESIDENT_BLOCK_FRACTION, REGISTRY)
from . import advisor as advisor_mod
from . import bsi as bsi_mod
from . import fusion as fusion_mod
from . import groupby as groupby_mod
from . import kernels
from . import repair as repair_mod
from . import residency as residency_mod
from . import sparse as sparse_mod
from .errors import HostFallback, ResidencyMiss, UnsupportedLowering  # noqa: F401 (re-exported)
from .fusion import decode_topn_full
from .mesh import host_stack, put_stack, resolve_device, shard_mask

# count()/count_async()'s "the caller probed the memo already" default.
_MEMO_UNSET = object()

# Result-memo capacity (entries); ``result_memo.maxsize = 0`` turns it off.
DEFAULT_RESULT_MEMO = 4096


# The default device budget: this fraction of the card's memory
# (``torch.cuda.mem_get_info``'s total when the engine is built: 63.8 GB
# of an H100 80GB HBM3's 85.0 GB), leaving the rest to the caching
# allocator's scratch, launch buffers, the CUDA context and the host lane's
# fragment mirrors.  The reference's 8 GiB (DEFAULT_RESIDENCY_BYTES) is a
# TPU's figure.
DEFAULT_BUDGET_FRACTION = 0.75

# Device and summary bytes one (row, shard) of a full stack charges the
# budget: its int32[WORDS] words plus the uint64 occupancy and
# resident-block summaries (the reference's _row_shard_bytes, engine.py
# :1210), so the port and the reference decide alike under one budget.
ROW_SHARD_BYTES = bitops.WORDS * 4 + 16


class _FieldStack:
    """Device-resident int32[R, S, WORDS] for one (index, field, view),
    rows major so a row slice is one contiguous [S, WORDS] block; or, for
    a partial stack, the block pool of its promoted rows."""

    __slots__ = ("matrix", "row_index", "versions", "shards", "occ", "frag_sync",
                 "home", "written", "reads", "partial", "absent_rows", "block_mask",
                 "universe_rows", "universe_blocks", "footprint", "pool", "slot_of",
                 "pool_next", "free_dirty", "slot_table")

    def __init__(self, matrix: torch.Tensor, row_index: Dict[int, int],
                 versions, shards: List[int], occ: np.ndarray, frag_sync=(),
                 home=None, partial=False, absent_rows=None, block_mask=None,
                 universe_rows=None, universe_blocks=None, slot_of=None, pool_next=0,
                 slot_table=None):
        self.matrix = matrix
        self.row_index = row_index
        self.versions = versions
        self.shards = shards
        # EXACT host-side block-occupancy summary, uint64[R, S]: bit b of
        # occ[r, s] set iff occupancy block b of (row r, shard s) holds a
        # set bit.  The sparse plan combines these through the query tree
        # to decide which device blocks to read at all, so a missing bit
        # here would silently undercount.
        self.occ = occ
        # Per canonical shard: (weakref to the fragment, or None, and the
        # fragment version the stack holds).  The incremental sync asks
        # each fragment for what changed since that version; a stack with
        # none (``convert.stack_from_numpy``) is rebuilt at its first write.
        self.frag_sync = frag_sync
        # Device ordering of in-place writes (``_scatter_chain``): the
        # stream of the last write, the event after it, and per other
        # stream the event after its last launch that read the stack.
        self.home = home
        self.written: Optional[torch.cuda.Event] = None
        self.reads: Dict[int, torch.cuda.Event] = {}
        # -- tiered residency (pilosa_tpu/parallel/engine.py:175-260) -------
        # A PARTIAL stack holds only the promoted working-set rows:
        # row_index maps them to their rows of the occ / block_mask
        # summaries, absent_rows holds rows KNOWN EMPTY when promoted
        # (lowered to the zero slot vector), and any other row is not
        # resident: the lowering raises ResidencyMiss.
        self.partial = partial
        self.absent_rows = set() if absent_rows is None else absent_rows
        # uint64[R, S] blocks whose device words are valid (partial stacks;
        # None on full ones): a promotion uploads every occupied block of a
        # promoted row, so mask >= occ is the invariant the sparse plan
        # re-checks before trusting a partial stack.
        self.block_mask = block_mask
        # The row universe and its occupied blocks when (re)built: the
        # denominators of the resident fractions.
        self.universe_rows = matrix.shape[0] if universe_rows is None else universe_rows
        self.universe_blocks = universe_blocks
        # Bytes charged to the budget: the device matrix plus the host
        # summaries (the slot table is not counted, as the reference does
        # not count its slot vectors).
        self.footprint = int(matrix.numel()) * matrix.element_size() + int(occ.nbytes) + (
            0 if block_mask is None else int(block_mask.nbytes))
        # -- the packed 2 KiB block pool (partial stacks) --------------------
        # With ``slot_of``, ``matrix`` is a pool int32[P, S, 512]: each
        # promoted row maps to an int32[64] slot vector (slot 0, the
        # reserved all-zero block, for a block empty in every shard), so a
        # partial stack costs one 2 KiB block per occupied (row, block) and
        # shard.  ``slot_table`` int32[len(row_index) + 1, 64] on the card
        # holds the vectors, row ``row_index[r]`` for row r and the last row
        # all zero; the kernels read it in place.
        self.pool = slot_of is not None
        self.slot_of = slot_of  # row -> np.int32[64]
        self.pool_next = pool_next  # first never-written slot
        self.free_dirty: List[int] = []  # freed slots: zero-filled on reuse
        self.slot_table = slot_table

    def slot_vec(self, row_id) -> int:
        """The slot-table row of ``row_id`` (the all-zero last row for
        None or a row without blocks)."""
        ridx = None if row_id is None else self.row_index.get(row_id)
        return self.slot_table.shape[0] - 1 if ridx is None else ridx

    def resident_fraction(self) -> float:
        """Resident rows / row universe (1.0 for full stacks)."""
        if not self.partial or not self.universe_rows:
            return 1.0
        return min(1.0, len(self.row_index) / self.universe_rows)


class _Lowering:
    """The field stacks one query program reads.  ``stack_for`` fetches
    each (index, field, view) once, so the query sees one consistent
    snapshot; ``add_matrix`` dedups stacks into program slots.
    ``row_hints`` maps each (index, field, view) to the rows the query
    touches there (None: the whole stack), collected before lowering
    (``TorchEngine._collect_row_hints``), so that a miss requests one
    promotion of the query's whole working set."""

    def __init__(self, engine: "TorchEngine", canonical: List[int]):
        self.engine = engine
        self.canonical = canonical
        self.mats: List[torch.Tensor] = []
        self.stacks: List[_FieldStack] = []
        self._slots: Dict[int, int] = {}
        self._by_key: dict = {}
        self.row_hints: Dict[tuple, Optional[set]] = {}

    def stack_for(self, index, field, view) -> Optional[_FieldStack]:
        key = (index, field, view)
        if key not in self._by_key:
            self._by_key[key] = self.engine.field_stack(
                index, field, view, self.canonical, rows_hint=self.row_hints.get(key)
            )
        return self._by_key[key]

    def add_matrix(self, stack: _FieldStack) -> int:
        """The program slot of a stack's matrix; a pool's slot table takes
        the slot after it (``mats`` and ``stacks`` stay aligned)."""
        i = self._slots.get(id(stack.matrix))
        if i is None:
            i = self._slots[id(stack.matrix)] = len(self.mats)
            self.mats.append(stack.matrix)
            self.stacks.append(stack)
            if stack.pool:
                self.mats.append(stack.slot_table)
                self.stacks.append(stack)
        return i


class _ResultMemo:
    """Bounded LRU of Count results keyed by (index, query text, shard
    set, version tokens) — ``TorchEngine._memo_key``; a copy of
    ``pilosa_tpu/parallel/engine.py:412 _ResultMemo``.

    The version tokens ARE the invalidation: every fragment write bumps
    its view's version, a key computed after the write carries the new
    token and simply misses, and the stale entry ages out of the LRU.  No
    write-path hook and no sweep: a stale hit after a write cannot happen
    rather than being merely tested for.

    Values are host ints (stored by ``count`` and the batcher's collect
    stage) or 0-d device tensors (stored by ``count_async`` before any
    readback); both satisfy ``int()``."""

    __slots__ = ("maxsize", "_od", "_lock", "hits", "misses", "_sig_tokens")

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._od: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # (index, query, shards) -> last-stored version-token tuple: WHY a
        # memo missed (``miss_reason``), bounded like the entries.
        self._sig_tokens: "OrderedDict" = OrderedDict()

    def get(self, key):
        if self.maxsize <= 0 or key is None:
            return None
        with self._lock:
            v = self._od.get(key)
            if v is None:
                self.misses += 1
                return None
            self._od.move_to_end(key)
            self.hits += 1
            return v

    def peek(self, key) -> bool:
        """Membership without an LRU bump or hit/miss accounting: the
        Explain dry-run must not change which entry is evicted next."""
        if self.maxsize <= 0 or key is None:
            return False
        with self._lock:
            return key in self._od

    def put(self, key, value):
        if self.maxsize <= 0 or key is None or value is None:
            return
        with self._lock:
            self._od[key] = value
            self._od.move_to_end(key)
            self._sig_tokens[key[:3]] = key[3]
            self._sig_tokens.move_to_end(key[:3])
            while len(self._od) > self.maxsize:
                self._od.popitem(last=False)
            while len(self._sig_tokens) > self.maxsize:
                self._sig_tokens.popitem(last=False)

    def miss_reason(self, key) -> str:
        """Why a key missed: the same (index, query, shards) stored under
        DIFFERENT tokens means a write advanced a version token since;
        the same tokens mean the entry was evicted; an unseen signature is
        cold."""
        if key is None:
            return "ineligible"
        with self._lock:
            toks = self._sig_tokens.get(key[:3])
        if toks is None:
            return "first_seen"
        return "evicted" if toks == key[3] else "version_token_advanced"

    def clear(self):
        with self._lock:
            self._od.clear()
            self._sig_tokens.clear()


class _TopNCandidates:
    """Candidate set + per-shard row-count matrix for the fused TopN.

    ``cands`` is the id-DESCENDING union of the per-fragment ranked-cache
    entries (fragment.go :1018-1040), descending so that the trim's
    lower-index tie-break equals the (-count, -id) pair order.  ``host_cnt``
    int32[S, K_pad] holds each candidate's STORE row count per canonical
    shard (the phase-2 ``cnt`` gate); ``dev_cnt`` is its device twin laid
    out [K_pad, S] like the kernel's scores, and ``cand_idx`` int32[K_pad]
    the stack rows to score.  Pad slots and absent rows name row 0 and
    carry count 0, so the gate (thr >= 1) drops them."""

    __slots__ = ("cands", "cand_idx", "dev_cnt", "host_cnt")

    def __init__(self, cands, cand_idx, dev_cnt, host_cnt):
        self.cands = cands
        self.cand_idx = cand_idx
        self.dev_cnt = dev_cnt
        self.host_cnt = host_cnt


class IngestSyncer:
    """Ingest device-sync worker (``pilosa_tpu/parallel/engine.py``
    IngestSyncer).

    An import mutates host truth in the caller's thread and then calls
    ``notify(index)``; this worker scatter-syncs the index's RESIDENT
    stacks (``TorchEngine.warm_sync``) on its own thread, so the next
    import's host work overlaps the device scatter of the last, and
    imports that land while a pass is pending coalesce into one
    ``sync_snapshot`` drain and one scatter chain.  It only moves
    freshness: a query that comes first syncs on demand in
    ``field_stack``.  ``flush()`` waits for every pending notify."""

    def __init__(self, engine: "TorchEngine"):
        self._engine = engine
        self._cv = threading.Condition()
        self._pending: set = set()
        self._busy = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self.chunks = 0
        self.coalesced = 0
        self.syncs = 0
        self.stacks_synced = 0
        # The last warm-sync failure: the worker keeps running, and the
        # next query on that stack syncs (and raises) on demand.
        self.last_error: Optional[BaseException] = None

    def notify(self, index: str):
        """Mark an index's resident stacks stale and wake (or start) the
        worker.  Never waits on device work."""
        with self._cv:
            if self._closed:
                return
            self.chunks += 1
            if index in self._pending:
                self.coalesced += 1
            self._pending.add(index)
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="ingest-sync",
                                                daemon=True)
                self._thread.start()
            self._cv.notify()

    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                drain = list(self._pending)
                self._pending.clear()
                self._busy = True
            try:
                for index in drain:
                    try:
                        self.stacks_synced += self._engine.warm_sync(index)
                    except Exception as e:  # noqa: BLE001 — the query path syncs on demand
                        self.last_error = e
                self.syncs += 1
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every pending notify has synced; False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=5)


class TorchEngine:
    # Above this candidate-union size the fused TopN declines and the
    # executor runs the two-phase composition (engine.py:4197).
    MAX_TOPN_CANDIDATES = 4096
    # Fused GroupBy combination cap: prod(K_i) above it goes to the host
    # iterator (engine.py:4571), as K8's counters live in shared memory.
    MAX_GROUP_COMBOS = groupby_mod.MAX_GROUP_COMBOS

    # Rows per promotion chunk: the host assembly of chunk N+1 overlaps the
    # upload of chunk N.
    PROMOTE_CHUNK_ROWS = 64
    # Warm start admits up to this fraction of the budget; the rest is the
    # on-demand lane for queries and their promotions.
    WARM_TARGET_FRACTION = 0.9

    def __init__(self, holder, device=None, max_resident_bytes: Optional[int] = None,
                 journal=None, logger=None):
        """``max_resident_bytes`` is the device budget of resident stacks
        (the server's ``[engine] device-budget-bytes``); None or 0 takes
        DEFAULT_BUDGET_FRACTION of the card's memory, and on the CPU no
        bound.  It counts bytes the engine owns (stack footprints,
        promotions in flight, evicted stacks a launch may still read),
        never ``mem_get_info``'s free figure: PyTorch's caching allocator
        keeps what an eviction frees."""
        self.holder = holder
        self.device = resolve_device(device)
        self.logger = logger
        self.journal = journal if journal is not None else events_mod.JOURNAL
        if not max_resident_bytes:
            max_resident_bytes = self.default_budget()
        self.max_resident_bytes = int(max_resident_bytes)
        self._stacks: "OrderedDict[Tuple[str, str, str], _FieldStack]" = OrderedDict()
        # Serializes stack build, sync and every dispatch from lowering to
        # launch: a query's plan (its occupancy) and its launch see one
        # state of the stacks, and a sync never lands between them.
        self._stacks_lock = threading.RLock()
        self._canonical: Dict[str, Tuple[int, List[int]]] = {}
        self._masks: "OrderedDict[Tuple[int, bytes], torch.Tensor]" = OrderedDict()
        # Full stack (re)builds, and in-place syncs of a resident stack.
        self.stack_rebuilds = 0
        self.stack_updates = 0
        self._ingest_syncer: Optional[IngestSyncer] = None
        # Occupancy-guided block skipping: when the surviving block
        # fraction is at or under this threshold the count runs on K2.
        # 0.25 is the JAX package's prior; the crossover on this card is
        # still to be measured (ROADMAP.md Queue 1 item 7).
        self.sparse_threshold = 0.25
        self.dense_dispatches = 0
        self.sparse_dispatches = 0
        self.device_bytes_skipped = 0
        # The path the last count dispatch took: "dense" or "sparse".
        self.last_path: Optional[str] = None
        # (index, field) -> (stack token, _TopNCandidates): the cache-fed
        # TopN candidate build, rebuilt when the stack's token moves.
        self._topn_cands: Dict[Tuple[str, str], tuple] = {}
        # Versioned result memo (_ResultMemo) and the memo-key signature
        # cache: id(call) -> [call, query text, fields, referenced bit].
        self.result_memo = _ResultMemo(DEFAULT_RESULT_MEMO)
        self._memo_sig_cache: Dict[int, list] = {}
        self._memo_sig_lock = threading.Lock()
        # Repair-on-write layer (repair.py): memo entries carrying their
        # query's row/field footprint, advanced to the current version
        # tokens from write deltas instead of recomputed.
        self.repairs = repair_mod.RepairLayer(self)
        # The cross-request micro-batcher (batcher.py), made at first use.
        self._batcher = None
        self._batcher_lock = threading.Lock()
        # K5 launches of count_many, and batch entries answered by
        # another entry of the same batch (batch CSE).
        self.batch_dispatches = 0
        self.batch_cse_deduped = 0
        # Batched Counts sent to the host lane because a tree of their
        # batch is past the kernels' limits (more than MAX_RANGES range
        # leaves, say): every Count of that batch.
        self.batch_declines = 0
        # Fused GroupBy launches (K8), and GroupBys past MAX_GROUP_COMBOS
        # (or MAX_GROUP_FIELDS) sent to the executor's host iterator.
        self.group_dispatches = 0
        self.group_host_fallbacks = 0
        # Whole-dashboard fusion: drains launched as fused programs, the
        # items that rode them, distinct masks evaluated and mask
        # references asked for (the gap is the evaluations fusion saved;
        # util/stats.py names their series), parts past F1's limits run on
        # per-op programs, and the plan cache (drain shape -> FusedPlan).
        self.fused_programs = 0
        self.fused_program_queries = 0
        self.fused_masks_evaluated = 0
        self.fused_masks_referenced = 0
        self.fused_declines = 0
        self.fused_plan_hits = 0
        self.fused_plan_misses = 0
        self._fused_plans: "OrderedDict[tuple, object]" = OrderedDict()
        # Warm-start progress ({total, built, skipped, done}); None until
        # warm_start runs.
        self.warm_state: Optional[dict] = None
        # -- tiered residency ------------------------------------------------
        # Footprints of the resident stacks, and (weakref to an evicted
        # matrix, its bytes) for evicted stacks a queued launch may still
        # read: both count against the budget until the tensor is freed.
        self._resident_bytes = 0
        self._pending_free: list = []
        self.residency = residency_mod.ResidencyManager(self)
        # Queries answered from the host tier because their stack (or rows)
        # was not resident, and stacks evicted (for the budget, or replaced
        # by a re-promotion or a rebuild of the same key).
        self.host_fallbacks = 0
        self.evictions = 0
        # Of them, the stacks evicted to make room under the budget.
        self.budget_evictions = 0
        self._evictions_counter = REGISTRY.counter(METRIC_ENGINE_EVICTIONS)
        # Per-cache hit/miss tallies and their process-metric handles,
        # resolved once per engine (pilosa_tpu/parallel/engine.py:975-990).
        self.cache_stats: Dict[str, List[int]] = {name: [0, 0] for name in ENGINE_CACHES}
        self._cache_counters = {
            name: (REGISTRY.counter(METRIC_ENGINE_CACHE_HITS, cache=name),
                   REGISTRY.counter(METRIC_ENGINE_CACHE_MISSES, cache=name))
            for name in ENGINE_CACHES}
        self._bytes_skipped_counter = REGISTRY.counter(METRIC_DEVICE_BYTES_SKIPPED)
        self._promotions_warm_counter = REGISTRY.counter(METRIC_ENGINE_PROMOTIONS,
                                                         cause="warm_start")
        # Per thread: fallbacks raised while probing (the batcher's failure
        # attribution, a promotion's commit) are not counted again.
        self._probe_tls = threading.local()
        # Eviction pricing: index -> device-cost signal (higher = hotter =
        # evicted later), LRU among equals.  The default is the plan
        # ledger's per-tenant device-cost EWMA (tenants default to the
        # index name at the serving layer); tests override it.
        self.cost_of_index = lambda index: plans_mod.LEDGER.cost_ewma(index)
        # Working-set heat asks this engine for the resident-vs-host split
        # (/debug/heat, pilosa_engine_residency_gap_bytes), and the prefetch
        # advisor drives its promote-ahead requests into this engine's
        # residency.  Both bindings are weak: neither pins a closed engine.
        heat_mod.HEAT.bind_engine(self)
        advisor_mod.ADVISOR.bind_engine(self)
        self._closed = False
        self.last_promote_error: Optional[str] = None
        # key -> (version token, occupied blocks of the row universe).
        self._universe_blocks_at: Dict[tuple, tuple] = {}

    def _cache_hit(self, name: str):
        self.cache_stats[name][0] += 1
        self._cache_counters[name][0].inc()

    def _cache_miss(self, name: str):
        self.cache_stats[name][1] += 1
        self._cache_counters[name][1].inc()

    # -- canonical shard axis ---------------------------------------------

    def canonical_shards(self, index: str) -> List[int]:
        """The index's local-fragment shard list: the one shard axis every
        stack of this index is laid out over, cached behind the holder's
        shard epoch."""
        epoch = self.holder.shard_epoch(index)
        cached = self._canonical.get(index)
        if cached is not None and cached[0] == epoch:
            self._cache_hit("canonical")
            return cached[1]
        self._cache_miss("canonical")
        shards = self.holder.local_shards(index)
        self._canonical[index] = (epoch, shards)
        return shards

    def _mask_words(self, shards, canonical) -> torch.Tensor:
        """int32[S] per-shard gate on the device: 1 for requested shards,
        0 otherwise.  Cached per bitset — masks recur across a stream."""
        req = set(shards)
        bits = bytes(1 if s in req else 0 for s in canonical)
        key = (len(canonical), bits)
        m = self._masks.get(key)
        if m is None:
            self._cache_miss("mask")
            pos = [i for i, b in enumerate(bits) if b]
            m = self._masks[key] = shard_mask(len(canonical), pos, self.device)
            while len(self._masks) > 1024:  # tiny buffers, but bounded
                self._masks.popitem(last=False)
        else:
            self._cache_hit("mask")
            self._masks.move_to_end(key)
        return m

    # -- residency ---------------------------------------------------------

    def default_budget(self) -> int:
        """DEFAULT_BUDGET_FRACTION of the card's memory; no bound on the CPU."""
        if self.device.type != "cuda":
            return 1 << 62
        _, total = torch.cuda.mem_get_info(self.device)
        return int(total * DEFAULT_BUDGET_FRACTION)

    def _token(self, index: str, view_obj) -> tuple:
        return (
            self.holder.shard_epoch(index),
            0 if view_obj is None else view_obj.gen,
            -1 if view_obj is None else view_obj.version,
        )

    def field_stack(self, index: str, field: str, view: str,
                    canonical: Optional[List[int]] = None,
                    rows_hint: Optional[set] = None) -> Optional[_FieldStack]:
        """The device stack of every row of a view across the index's
        canonical shard axis: synced in place when the view changed, and
        rebuilt whole only when the sync cannot cover the change.
        ``rows_hint`` is the rows the caller's query touches (None: the
        whole stack).  It changes nothing while the full stack fits the
        budget; past it, it is what the promotion admits, and the call
        raises ``ResidencyMiss`` so the query is served from the host tier
        meanwhile."""
        if canonical is None:
            canonical = self.canonical_shards(index)
        key = (index, field, view)
        with self._stacks_lock:
            return self._field_stack_locked(key, index, field, view, canonical, rows_hint)

    def _field_stack_locked(self, key, index, field, view, canonical, rows_hint=None):
        view_obj = self.holder.view(index, field, view)
        token = self._token(index, view_obj)
        cached = self._stacks.get(key)
        if cached is not None and cached.versions == token and cached.shards == canonical:
            self._cache_hit("stack")
            self._stacks.move_to_end(key)
            return cached
        prior_rows = None
        if cached is not None:
            updated = self._try_incremental_sync(cached, index, field, view, canonical, token)
            if updated is not None:
                # An in-place sync reuses the resident matrix: a hit.
                self._cache_hit("stack")
                self._stacks.move_to_end(key)
                return updated
            if cached.partial:
                # A rebuilt partial stack keeps its working set.
                prior_rows = set(cached.row_index)
            self._evict(key)
        if not canonical:
            return None
        self._cache_miss("stack")
        # Admission (pilosa_tpu/parallel/engine.py:1157-1175): price the
        # FULL stack from its row universe before any host assembly.  One
        # that fits is built now, colder stacks evicted to make room; one
        # that does not requests a promotion of the touched rows and sends
        # the query to the host tier.
        universe = self._row_universe(index, field, view, canonical)
        full_foot = max(1, len(universe)) * len(canonical) * ROW_SHARD_BYTES
        if not self._admissible(full_foot):
            if prior_rows:
                rows_hint = prior_rows if rows_hint is None else set(rows_hint) | prior_rows
            self._miss_to_host(key, rows_hint, 0.0, full_foot)
        frag_sync, row_index, buf, occ = self._assemble_host(index, field, view, canonical)
        self._evict_for(int(buf.numel()) * 4 + int(occ.nbytes))
        home = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                else None)
        stack = _FieldStack(put_stack(buf, self.device), row_index, token,
                            list(canonical), occ, frag_sync, home)
        self.stack_rebuilds += 1
        self._stacks[key] = stack
        self._resident_bytes += stack.footprint
        return stack

    def _row_universe(self, index, field, view, canonical) -> List[int]:
        """Sorted distinct row ids across the view's fragments: the
        admission estimate's rows and the partial stacks' denominator."""
        rows = set()
        for s in canonical:
            f = self.holder.fragment(index, field, view, s)
            if f is not None:
                rows.update(f.row_ids())
        return sorted(rows)

    def _pending_bytes(self) -> int:
        """Bytes of evicted matrices still alive (a queued launch or a
        caller may hold one); dead ones are dropped."""
        live = [(r, n) for r, n in self._pending_free if r() is not None]
        self._pending_free = live
        return sum(n for _, n in live)

    def _admissible(self, nbytes: int) -> bool:
        """Could ``nbytes`` fit the budget if every resident stack were
        evicted?  Evicted-but-live matrices and promotions in flight count
        (an evicted matrix held only by garbage awaiting the cycle
        collector is collected once before a refusal)."""
        def fits():
            return (nbytes + self._pending_bytes() + self.residency.inflight_bytes()
                    <= self.max_resident_bytes)

        if fits():
            return True
        if self._pending_free:
            gc.collect()
            return fits()
        return False

    def _evict_for(self, need_bytes: int, protect=frozenset()) -> bool:
        """Evict resident stacks until ``need_bytes`` more fits the budget.
        Victims are priced by predicted next touch, then cost, then LRU
        (pilosa_tpu/parallel/engine.py:1300-1343): a stack the prefetch
        advisor's outstanding advice names goes after every other one;
        within each class the cheapest index (``cost_of_index``) goes
        first, the least recently used among equals.  With no outstanding
        advice this is the cost/LRU order.  The budget is a SOFT target:
        when nothing more can go the caller admits anyway.  Runs under the
        stacks lock."""

        def fits():
            return (self._resident_bytes + self._pending_bytes()
                    + self.residency.inflight_bytes() + need_bytes
                    <= self.max_resident_bytes)

        if fits():
            return True
        predicted = advisor_mod.ADVISOR.predicted_keys()
        lru_pos = {k: i for i, k in enumerate(self._stacks)}
        order = sorted((k for k in self._stacks if k not in protect),
                       key=lambda k: (1 if k in predicted else 0,
                                      self._index_cost(k[0]), lru_pos[k]))
        for k in order:
            if fits():
                return True
            self._evict(k)
            self.budget_evictions += 1
        return fits()

    def _index_cost(self, index: str) -> float:
        """The eviction price of an index, tolerant of a broken hook."""
        try:
            return float(self.cost_of_index(index))
        except Exception:  # noqa: BLE001 — pricing never fails an admission
            return 0.0

    def _evict(self, key):
        """Drop a resident stack from the cache.  The tensor is never freed
        here: a queued launch or an in-flight dispatch may still read it,
        so its bytes stay counted (``_pending_free``) until the last
        reference goes.  Cached fused plans that read it are dropped, so
        they neither keep it alive nor serve it after a rebuild."""
        stack = self._stacks.pop(key, None)
        if stack is None:
            return
        self._resident_bytes -= stack.footprint
        self._pending_free.append((weakref.ref(stack.matrix),
                                   int(stack.matrix.numel()) * stack.matrix.element_size()))
        self.evictions += 1
        self._evictions_counter.inc()
        for pk in [k for k, plan in self._fused_plans.items() if key in plan.stack_tokens]:
            del self._fused_plans[pk]
        if not self._closed:
            index, field, view = key
            self.journal.append("engine.evict", index=index, field=field, view=view,
                                bytes=stack.footprint, residentBytes=self._resident_bytes)

    # -- working-set heat (pilosa_tpu/parallel/engine.py:1216-1277) ---------

    def residency_row_split(self, key, rows):
        """(resident subset of ``rows``, device bytes of one row) for the
        stack ``key``: the heat recorder's resident-vs-host split and the
        pilosa_engine_residency_gap_bytes numerator.  Read-only: a
        row_index membership walk under the stacks lock, never a build."""
        with self._stacks_lock:
            st = self._stacks.get(key)
            if st is not None:
                resident = {r for r in rows if int(r) in st.row_index}
                return resident, int(st.matrix.shape[1]) * ROW_SHARD_BYTES
        canonical = self.canonical_shards(key[0])
        return set(), len(canonical) * ROW_SHARD_BYTES

    @staticmethod
    def _touch_of(key, st, rows):
        """One heat touch for ``key``: the rows (None: the whole stack),
        their occupied-block count and the OR of their 64-bit occupancy
        masks, from the stack's host summary ``occ`` (no device read)."""
        if rows is None:
            return (key[0], key[1], key[2], None, 0, 0)
        rows_t = tuple(sorted(int(r) for r in rows))
        n_blocks = 0
        mask = 0
        if st is not None and st.occ is not None:
            R = st.occ.shape[0]
            for r in rows_t:
                ridx = st.row_index.get(r)
                if ridx is None or ridx >= R:
                    continue
                m = int(np.bitwise_or.reduce(st.occ[ridx]))
                n_blocks += m.bit_count()
                mask |= m
        return (key[0], key[1], key[2], rows_t, n_blocks, mask)

    def _note_touches(self, lw: _Lowering):
        """Stamp the dispatch note with the touches this lowering's row
        hints resolve to: the heat recorder's input.  Free when plans or
        heat are off."""
        if not (plans_mod.ENABLED and heat_mod.HEAT.enabled) or not lw.row_hints:
            return
        touches = [self._touch_of(key, lw._by_key.get(key), rows)
                   for key, rows in lw.row_hints.items()]
        if touches:
            plans_mod.note_dispatch(touches=touches)

    # -- the host-lane fallback protocol (engine.py:1353-1440) --------------

    def _host_fallback(self, key, rows, fraction: float, msg: str):
        """Count the fallback, request the promotion and raise
        ResidencyMiss, so that the executor serves the query from the host
        tier.  In probe mode (``probe_residency``: the batcher re-lowering
        items whose batch already failed, a promotion's commit) the
        counters stay still; the request (merged by the manager) still
        lands."""
        if not getattr(self._probe_tls, "quiet", False):
            self.host_fallbacks += 1
            self.residency.note_host_fallback()
        self.residency.request(key, rows, cause="reactive")
        # The plan note the /debug/plans analyzer renders as "host
        # fallback: stack NN% resident".  The miss is a working-set touch
        # too: heat sees the rows this query wanted although no device
        # bytes moved, so the residency gap rises as traffic outruns
        # promotion.
        plans_mod.note_dispatch(
            path="host_fallback", stack="/".join(key),
            resident_fraction=round(fraction, 4),
            touches=[(key[0], key[1], key[2],
                      None if rows is None else tuple(sorted(rows)), 0, 0)])
        raise ResidencyMiss(msg, key=key, resident_fraction=fraction)

    class _ProbeMode:
        __slots__ = ("_tls",)

        def __init__(self, tls):
            self._tls = tls

        def __enter__(self):
            self._tls.quiet = True

        def __exit__(self, *exc):
            self._tls.quiet = False
            return False

    def probe_residency(self):
        """A context in which this thread's residency fallbacks are probes
        (not counted again)."""
        return self._ProbeMode(self._probe_tls)

    def _miss_to_host(self, key, rows_hint, fraction: float, need_bytes: int):
        """A stack is not resident and does not fit whole."""
        self._host_fallback(
            key, rows_hint, fraction,
            f"stack {key} not device-resident ({need_bytes} B vs budget "
            f"{self.max_resident_bytes} B); promotion requested, serving from the host tier")

    def _partial_miss(self, index, field, view, row_id, lw, stack):
        """A query touched a row outside a partial stack's working set:
        request the query's whole hinted working set (and this row)."""
        key = (index, field, view)
        hint = lw.row_hints.get(key) if lw is not None else None
        rows = set(hint) if hint else set()
        rows.add(int(row_id))
        frac = stack.resident_fraction()
        self._host_fallback(key, rows, frac,
                            f"row {row_id} of {key} not resident ({frac:.0%} of the stack "
                            "is); promotion requested")

    def _require_full_stack(self, index, field, view, stack):
        """Aggregates (BSI planes, TopN candidates, GroupBy fields) read
        whole stacks: a partial one requests the full promotion and sends
        the query to the host tier."""
        if stack is None or not stack.partial:
            return stack
        frac = stack.resident_fraction()
        self._host_fallback((index, field, view), None, frac,
                            f"aggregate over partial stack {(index, field, view)} "
                            f"({frac:.0%} resident); full promotion requested")

    # -- asynchronous promotion (pilosa_tpu/parallel/engine.py:1719-2010) ---

    def _log(self, msg: str):
        """A promotion the worker could not finish: kept for
        ``cache_snapshot`` and logged; the host tier keeps serving."""
        self.last_promote_error = msg
        if self.logger is not None:
            self.logger.printf("%s", msg)

    def _promote(self, key, rows, cause="reactive", trace_id=""):
        """Promote ``key``'s working set to the card; runs on the residency
        worker.  ``rows`` is the merged row set of the misses (None: the
        whole stack).  Returns (outcome, bytes shipped), outcome one of
        "full", "partial", "declined" or "skipped".

        The fragments' sync points are taken before any row is read, so a
        write landing mid-promotion leaves the committed stack behind it,
        and the commit's token re-check syncs it at once through
        ``_try_incremental_sync`` (an idempotent word set), before any query
        reads the stack.  A whole stack that fits the budget is built as a
        query would build it; otherwise the rows' occupied blocks go to a
        block pool: one slot per (row, block occupied in any shard), slot 0
        all zero, a power-of-two capacity with 2x headroom that never
        shrinks for this stack, uploaded in chunks of PROMOTE_CHUNK_ROWS
        rows whose host assembly overlaps the previous chunk's copy.  The
        uploads run on this thread's current stream (the default stream,
        the queries' own), so no query reads the pool before they land."""
        index, field, view = key
        if self._closed:
            return "skipped", 0
        with self._stacks_lock:
            canonical = self.canonical_shards(index)
            if not canonical:
                return "skipped", 0
            token = self._token(index, self.holder.view(index, field, view))
            existing = self._stacks.get(key)
            if existing is not None and not existing.partial and existing.versions == token:
                return "skipped", 0  # a query built it first
            want = None if rows is None else set(rows)
            if existing is not None and existing.partial and want is not None:
                want |= set(existing.row_index)  # growth keeps the working set
        # Unlocked host walk; sync points FIRST.
        frags = [self.holder.fragment(index, field, view, s) for s in canonical]
        frag_sync = [(None, -1) if f is None else (weakref.ref(f), f._version) for f in frags]
        universe = sorted({r for f in frags if f is not None for r in f.row_ids()})
        universe_blocks = self._universe_blocks(key, token, frags)
        S = len(canonical)
        full_foot = max(1, len(universe)) * S * ROW_SHARD_BYTES
        if want is None or self._admissible(full_foot):
            if not self._admissible(full_foot):
                return "declined", 0
            self.residency.add_inflight(full_foot)
            credited = True
            try:
                with self._stacks_lock:
                    self._evict_for(0, protect=frozenset((key,)))
                sync2, row_index, buf, occ = self._assemble_host(index, field, view, canonical)
                mat = put_stack(buf, self.device)
                self.residency.sub_inflight(full_foot)
                credited = False
                return self._commit_promotion(
                    key, canonical, token, sync2, row_index, mat, occ, partial=False,
                    absent=set(), universe_rows=len(universe), universe_blocks=universe_blocks,
                    shipped=int(buf.numel()) * 4, cause=cause, trace_id=trace_id)
            finally:
                if credited:
                    self.residency.sub_inflight(full_foot)
        uni = set(universe)
        target = sorted(r for r in want if r in uni)
        absent = {r for r in want if r not in uni}
        if not target and not absent:
            return "skipped", 0
        BW = bitops.OCC_BLOCK_WORDS
        slot_of: Dict[int, np.ndarray] = {}
        next_slot = 1
        for r in target:
            u = 0
            for f in frags:
                if f is not None and f.row_count(r):
                    u |= int(f.row_occupancy(r))
            vec = np.zeros(bitops.OCC_BLOCKS, dtype=np.int32)
            while u:
                blk = (u & -u).bit_length() - 1
                vec[blk] = next_slot
                next_slot += 1
                u &= u - 1
            slot_of[r] = vec
        P_cap = 1 << max(3, (2 * next_slot - 1).bit_length())
        with self._stacks_lock:
            prev = self._stacks.get(key)
            if prev is not None and prev.pool:
                P_cap = max(P_cap, int(prev.matrix.shape[0]))
        part_foot = P_cap * S * BW * 4 + len(target) * S * 16
        if not self._admissible(part_foot):
            return "declined", 0
        self.residency.add_inflight(part_foot)
        credited = True
        try:
            with self._stacks_lock:
                self._evict_for(0, protect=frozenset((key,)))
            pool = torch.zeros((P_cap, S, BW), dtype=torch.int32, device=self.device)
            row_index = {r: i for i, r in enumerate(target)}
            occ = np.zeros((len(target), S), dtype=np.uint64)
            shipped = 0
            for ci in range(0, len(target), self.PROMOTE_CHUNK_ROWS):
                chunk = target[ci: ci + self.PROMOTE_CHUNK_ROWS]
                updates, sb = self._assemble_pool_chunk(chunk, row_index, slot_of, frags, occ)
                shipped += sb
                if updates:
                    self._upload_blocks(pool, updates)
            table = np.zeros((len(target) + 1, bitops.OCC_BLOCKS), dtype=np.int32)
            for r, i in row_index.items():
                table[i] = slot_of[r]
            slot_table = self._upload(table)
            self.residency.sub_inflight(part_foot)
            credited = False
            return self._commit_promotion(
                key, canonical, token, frag_sync, row_index, pool, occ, partial=True,
                absent=absent, universe_rows=len(universe), universe_blocks=universe_blocks,
                shipped=shipped, cause=cause, trace_id=trace_id, slot_of=slot_of,
                pool_next=next_slot, slot_table=slot_table)
        finally:
            if credited:
                self.residency.sub_inflight(part_foot)

    def _universe_blocks(self, key, token, frags) -> int:
        """Occupied blocks over a view's whole row universe (the partial
        stacks' resident-fraction denominator): every row's occupancy, a
        scan of its words, so it is kept per (key, token) and a stack
        promoted again at the same version pays for it once."""
        hit = self._universe_blocks_at.get(key)
        if hit is not None and hit[0] == token:
            return hit[1]
        n = sum(int(f.row_occupancy(r)).bit_count()
                for f in frags if f is not None for r in f.row_ids())
        self._universe_blocks_at[key] = (token, n)
        return n

    _BLOCK_BITS = np.arange(bitops.OCC_BLOCKS, dtype=np.uint64)

    def _assemble_pool_chunk(self, chunk_rows, row_index, slot_of, frags, occ):
        """Host half of one promotion chunk: each (row, shard)'s words,
        its occupancy computed from those words (never a second read), and
        its occupied blocks with their slots, so only occupied blocks cross
        the bus.  A block occupied by a write that raced the slot
        assignment has no slot: it is left out of both the upload and the
        occupancy, and the write's version replays it through the sync
        after the commit.  Returns ([(slots int64[k], shard, blocks
        uint32[k, 512])], bytes)."""
        BW = bitops.OCC_BLOCK_WORDS
        parts: list = []
        shipped = 0
        for r in chunk_rows:
            ri = row_index[r]
            slots = slot_of[r]
            slotted = np.uint64(int(np.packbits(slots != 0, bitorder="little").view("<u8")[0]))
            for si, f in enumerate(frags):
                if f is None or not f.row_count(r):
                    continue  # empty (a write since the sync points replays)
                words = np.asarray(f.row_words(r), dtype=np.uint32)
                kept = np.uint64(bitops.occupancy64(words)) & slotted
                if not kept:
                    continue
                ids = np.flatnonzero((kept >> self._BLOCK_BITS) & np.uint64(1))
                parts.append((slots[ids].astype(np.int64), si, words.reshape(-1, BW)[ids]))
                shipped += len(ids) * BW * 4
                occ[ri, si] = kept
        return parts, shipped

    def _upload_blocks(self, pool: torch.Tensor, parts):
        """Write a chunk's (slots, shard, blocks) into a private pool: the
        blocks go into one page-locked buffer and up with one non-blocking
        copy, then one ``index_put_``, so the caller's next chunk is
        assembled while this one crosses the bus."""
        n = sum(len(p[0]) for p in parts)
        pin = self.device.type == "cuda"
        vals = torch.empty((n, bitops.OCC_BLOCK_WORDS), dtype=torch.int32, pin_memory=pin)
        idx = torch.empty((2, n), dtype=torch.int64, pin_memory=pin)
        v, ix = vals.numpy().view(np.uint32), idx.numpy()
        o = 0
        for slots, si, blocks in parts:
            k = len(slots)
            ix[0, o: o + k] = slots
            ix[1, o: o + k] = si
            v[o: o + k] = blocks
            o += k
        if pin:
            vals = vals.to(self.device, non_blocking=True)
            idx = idx.to(self.device, non_blocking=True)
        pool.index_put_((idx[0], idx[1]), vals)

    def _commit_promotion(self, key, canonical, token, frag_sync, row_index, mat, occ,
                          partial, absent, universe_rows, shipped, universe_blocks=None,
                          cause="reactive", trace_id="", slot_of=None, pool_next=0,
                          slot_table=None):
        """Admit a promoted matrix under the stacks lock: a moved shard axis
        or a replaced view aborts (the next miss requests again), and a
        version a mid-promotion write advanced syncs at once through
        ``_field_stack_locked`` before any query can read the stack."""
        index, field, view = key
        with self._stacks_lock:
            if self._closed or self.canonical_shards(index) != canonical:
                return "skipped", shipped
            view_obj = self.holder.view(index, field, view)
            if (0 if view_obj is None else view_obj.gen) != token[1]:
                return "skipped", shipped
            if key in self._stacks:
                self._evict(key)
            home = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                    else None)
            stack = _FieldStack(
                mat, row_index, token, list(canonical), occ, frag_sync, home,
                partial=partial, absent_rows=set(absent),
                block_mask=occ.copy() if partial else None, universe_rows=universe_rows,
                universe_blocks=universe_blocks, slot_of=slot_of, pool_next=pool_next,
                slot_table=slot_table)
            if home is not None:
                stack.written = torch.cuda.Event()
                stack.written.record(home)
            self._evict_for(stack.footprint)
            self._stacks[key] = stack
            self._resident_bytes += stack.footprint
            self.stack_rebuilds += 1
            if self._token(index, view_obj) != token:
                # A write landed mid-promotion: sync now.  Probe mode: this
                # serves no query, so a miss here counts no fallback.
                try:
                    with self.probe_residency():
                        self._field_stack_locked(key, index, field, view, canonical)
                except ResidencyMiss:
                    plans_mod.take_dispatch_note()  # no plan on this thread
                    return "declined", shipped
            self.journal.append("engine.promotion", trace_id=trace_id or None, index=index,
                                field=field, view=view, cause=cause, partial=bool(partial),
                                rows=len(row_index), universeRows=int(universe_rows),
                                bytes=int(shipped))
        return ("partial" if partial else "full"), shipped

    def _assemble_host(self, index, field, view, canonical):
        """Host half of a stack build: walk the view's fragments and fill
        the dense [R, S, WORDS] staging buffer plus the exact occupancy
        summary, computed from the words just copied.  The fragments' sync
        points are taken before any row is read, so a write landing
        mid-build is newer than its sync point and the next sync ships it
        again (an idempotent word set), never loses it.  Returns
        (frag_sync, row_index, host buffer, occ)."""
        frags = [self.holder.fragment(index, field, view, s) for s in canonical]
        frag_sync = [(None, -1) if f is None else (weakref.ref(f), f._version)
                     for f in frags]
        row_ids = sorted({r for f in frags if f is not None for r in f.row_ids()})
        if not row_ids:
            row_ids = [0]
        row_index = {r: i for i, r in enumerate(row_ids)}
        S = len(canonical)
        buf, mat = host_stack((len(row_ids), S, bitops.WORDS), self.device)
        occ = np.zeros((len(row_ids), S), dtype=np.uint64)
        for si, f in enumerate(frags):
            if f is None:
                continue
            for r in f.row_ids():
                ri = row_index[r]
                mat[ri, si] = f.row_words(r)
                occ[ri, si] = bitops.occupancy64(mat[ri, si])
        return frag_sync, row_index, buf, occ

    # -- write path: in-place sync of resident stacks ----------------------
    # (pilosa_tpu/parallel/engine.py:2015-2289)

    # Rows per row-scatter launch: the chunk's host staging is rows x
    # 128 KiB, so a bulk sync of any size goes in bounded chunks.
    SCATTER_CHUNK_ROWS = 256

    def _try_incremental_sync(self, cached: _FieldStack, index, field, view, canonical,
                              token) -> Optional[_FieldStack]:
        """Bring a stale resident stack up to date by scattering only what
        each fragment's ``sync_snapshot`` reports changed since the
        stack's sync point: the changed words of a row, or the whole row
        when its word log does not cover the change.  A pool stack takes
        them as block writes (``_pool_sync_row``).  Returns the stack, or
        None when only a rebuild can cover the change: a new shard axis or
        view, a fragment replaced or removed, a new row of a full stack, a
        pool out of slots, or a sync point older than a storage load.  The
        occupancy summary takes each row's exact bitmap from the same
        snapshot as its words, and only once the scatter was enqueued
        without error; a failed scatter evicts the stack and re-raises."""
        if cached.shards != canonical or not cached.frag_sync:
            return None
        # A shard-epoch change alone does not bail (a fragment created in
        # a sibling field bumps the index's epoch); this stack's own
        # changes are caught below, fragment by fragment and row by row.
        if token[1] != cached.versions[1]:
            return None  # the view was replaced
        updates: List[Tuple[int, int, np.ndarray]] = []  # (row_idx, pos, words)
        word_updates: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        occ_updates: List[Tuple[int, int, int]] = []
        pool_rows: set = set()  # pool rows whose slot vectors may change
        n_words = 0
        new_sync = list(cached.frag_sync)
        view_obj = self.holder.view(index, field, view)
        frags = {} if view_obj is None else view_obj.fragments
        for si, s in enumerate(canonical):
            frag = frags.get(s)
            fref, synced = cached.frag_sync[si]
            if frag is None:
                if fref is not None:
                    return None  # fragment removed
                continue
            # Weakref identity, never id(): a recycled address would pass
            # for the old fragment and serve its rows forever.
            if fref is None or fref() is not frag:
                return None  # fragment new or replaced
            if frag._version == synced:
                continue  # clean: no lock taken
            snap = frag.sync_snapshot(synced)
            if snap is None:
                return None  # the sync point predates a storage load
            new_version, dirty = snap
            for r, upd in dirty.items():
                row_idx = cached.row_index.get(r)
                if row_idx is None:
                    if cached.partial:
                        # A row outside the working set changed: it is not
                        # resident, but may no longer be the known-empty
                        # row the lowering zeroes, so the next query over
                        # it misses and promotes it.
                        cached.absent_rows.discard(r)
                        continue
                    return None  # a new row: the stack's shape changes
                if cached.pool:
                    occ64 = self._pool_sync_row(cached, r, row_idx, si, upd, updates,
                                                word_updates)
                    if occ64 is None:
                        return None  # pool out of slots: rebuild at a new tier
                    pool_rows.add(r)
                    occ_updates.append((row_idx, si, occ64))
                    continue
                if upd[0] == "words":
                    _, widxs, vals, occ64 = upd
                    word_updates.append((row_idx, si, widxs, vals))
                else:
                    _, words, occ64 = upd
                    updates.append((row_idx, si, words))
                occ_updates.append((row_idx, si, occ64))
            new_sync[si] = (fref, new_version)
        n_words = sum(len(w[2]) for w in word_updates)
        table_rows = sorted(cached.row_index[r] for r in pool_rows)
        if updates or word_updates or table_rows:
            try:
                self._scatter_chain(cached, updates, word_updates, n_words, table_rows)
            except BaseException:
                key = (index, field, view)
                if self._stacks.get(key) is cached:
                    self._evict(key)
                raise
            # Occupancy lands only after the words did.  The resident-block
            # mask grows with it (mask >= occ stays invariant).
            for row_idx, si, occ64 in occ_updates:
                cached.occ[row_idx, si] = np.uint64(occ64)
                if cached.block_mask is not None:
                    cached.block_mask[row_idx, si] |= np.uint64(occ64)
            if pool_rows:
                self._free_empty_blocks(cached, pool_rows)
            self.stack_updates += 1
        cached.versions = token
        cached.frag_sync = new_sync
        return cached

    def _pool_sync_row(self, cached: _FieldStack, r, row_idx, si, upd, updates,
                       word_updates) -> Optional[int]:
        """Turn one dirty row's delta into block-pool writes
        (pilosa_tpu/parallel/engine.py:2142-2230).  A block the row newly
        occupies takes a slot: a never-written one (``pool_next``, still
        the zeros the pool was made with) or a freed one (``free_dirty``),
        whose words are zeroed in every shard first (the full-block
        entries go in ``updates``, which ``_scatter_chain`` writes before
        the word deltas).  Slot 0 is never written.  The slot vector
        changes on the host here and in the slot table with the scatter.
        Returns the shard's new occupancy, or None when the pool is out of
        slots."""
        BW = bitops.OCC_BLOCK_WORDS
        slots = cached.slot_of.get(r)
        if slots is None:
            return None
        S = cached.matrix.shape[1]
        P_cap = cached.matrix.shape[0]

        def alloc(cover_si):
            # cover_si: a full-block entry for (slot, si) follows in
            # ``updates``, so the zero fill skips that shard (two entries
            # for one (slot, shard) in one scatter would race).
            if cached.pool_next < P_cap:
                slot = cached.pool_next
                cached.pool_next += 1
                return slot
            if cached.free_dirty:
                slot = cached.free_dirty.pop()
                zero = np.zeros(BW, dtype=np.uint32)
                for sp in range(S):
                    if not (cover_si and sp == si):
                        updates.append((slot, sp, zero))
                return slot
            return None

        if upd[0] == "words":
            _, widxs, vals, occ64 = upd
            blk_of = np.asarray(widxs, dtype=np.int64) // BW
            for blk in np.unique(blk_of).tolist():
                sel = blk_of == blk
                slot = int(slots[blk])
                if slot == 0:
                    # Slot 0: the block was empty in EVERY shard at the
                    # sync point, so the changed words over zeros are the
                    # whole block.
                    slot = alloc(cover_si=False)
                    if slot is None:
                        return None
                    slots[blk] = slot
                word_updates.append((slot, si,
                                     (np.asarray(widxs)[sel] % BW).astype(np.int32),
                                     np.asarray(vals, dtype=np.uint32)[sel]))
            return int(occ64)
        # A whole row: every resident block takes its new words, and newly
        # occupied blocks take slots.
        words = np.asarray(upd[1], dtype=np.uint32)
        occ64 = int(upd[2])
        prev = int(cached.block_mask[row_idx, si])
        for blk in range(bitops.OCC_BLOCKS):
            has = (occ64 >> blk) & 1
            slot = int(slots[blk])
            if slot == 0:
                if not has:
                    continue
                slot = alloc(cover_si=True)
                if slot is None:
                    return None
                slots[blk] = slot
                updates.append((slot, si, words[blk * BW: (blk + 1) * BW]))
            elif has or (prev >> blk) & 1:
                # Occupied now, or stale words to zero out.
                updates.append((slot, si, words[blk * BW: (blk + 1) * BW]))
        return occ64

    def _free_empty_blocks(self, cached: _FieldStack, rows):
        """Return to ``free_dirty`` the slots of blocks a sync emptied in
        every shard of a pool row (their words are all zero now): the row's
        vector names slot 0 there again, and the slot's next owner zeroes
        it before use.  The slot table rows change on the next sync's
        scatter, or now."""
        changed = []
        for r in rows:
            ri = cached.row_index[r]
            union = int(np.bitwise_or.reduce(cached.occ[ri]))
            slots = cached.slot_of[r]
            for blk in np.flatnonzero(slots).tolist():
                if not (union >> blk) & 1:
                    cached.free_dirty.append(int(slots[blk]))
                    slots[blk] = 0
                    changed.append(ri)
        if changed:
            self._scatter_chain(cached, [], [], 0, sorted(set(changed)))

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host array on the engine's device: a pinned staging copy
        queued on the current stream without waiting (a no-op copy-free
        view on the CPU)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _scatter_chain(self, stack: _FieldStack, updates, word_updates, n_words,
                       table_rows=()):
        """Write a sync's changes into ``stack.matrix`` in place, on the
        current stream: whole rows ``matrix[row, pos] = words`` in chunks
        of SCATTER_CHUNK_ROWS, then changed words
        ``matrix[row, pos, word] = value`` as one batch, each an
        ``index_put_`` whose index and value arrays travel as one pinned,
        non-blocking copy each.  (The reference's XLA scatters
        ``_scatter_rows_impl`` / ``_scatter_words_impl``.)  On a pool stack
        a "row" is a 2 KiB block of a slot, a later entry for the same
        (slot, shard) replaces an earlier one (a recycled slot's zero fill
        and then its data), and ``table_rows`` are slot-table rows written
        from ``slot_of`` after the blocks.

        Device ordering.  The reference donates the old buffer and leans
        on one in-order stream; here the tensor is written in place, so a
        stack keeps its own rule.  Its ``home`` is the stream of its last
        write (the build's upload, or a scatter).  Work on the home stream
        is ordered by the stream itself.  A launch that reads the stack on
        another stream first waits for the event after the last write
        (``written``) and then records its own event in ``reads``
        (``_reading``).  A scatter enqueued from a stream other than home
        first waits for everything enqueued on home so far; every scatter
        waits for the recorded reads of other streams.  So a scatter never
        overwrites words a launch enqueued earlier on any stream still
        reads, and no launch on any stream reads before the scatter lands.
        The host side is held under ``_stacks_lock``: a dispatch's plan
        and its launch never straddle a sync."""
        mat = stack.matrix
        cur = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        if cur is not None:
            if stack.home is not None and stack.home != cur:
                ev = torch.cuda.Event()
                ev.record(stack.home)
                cur.wait_event(ev)
            for sid, ev in stack.reads.items():
                if sid != cur.cuda_stream:
                    cur.wait_event(ev)
        W = mat.shape[2]
        if stack.pool and updates:
            last = {(r, p): i for i, (r, p, _) in enumerate(updates)}
            updates = [updates[i] for i in sorted(last.values())]
        for ci in range(0, len(updates), self.SCATTER_CHUNK_ROWS):
            chunk = updates[ci: ci + self.SCATTER_CHUNK_ROWS]
            idx = np.asarray([(r, p) for r, p, _ in chunk], dtype=np.int64).T.copy()
            vals = np.empty((len(chunk), W), dtype=np.uint32)
            for i, (_, _, words) in enumerate(chunk):
                vals[i] = words
            ix = self._upload(idx)
            mat.index_put_((ix[0], ix[1]), self._upload(vals.view(np.int32)))
        if word_updates:
            idx = np.empty((3, n_words), dtype=np.int64)
            vals = np.empty(n_words, dtype=np.uint32)
            o = 0
            for r, p, widxs, wv in word_updates:
                k = len(widxs)
                idx[0, o: o + k] = r
                idx[1, o: o + k] = p
                idx[2, o: o + k] = widxs
                vals[o: o + k] = wv
                o += k
            ix = self._upload(idx)
            mat.index_put_((ix[0], ix[1], ix[2]), self._upload(vals.view(np.int32)))
        if table_rows:
            inv = {ri: r for r, ri in stack.row_index.items()}
            vecs = np.stack([stack.slot_of[inv[ri]] for ri in table_rows]).astype(np.int32)
            stack.slot_table.index_put_(
                (self._upload(np.asarray(table_rows, dtype=np.int64)),), self._upload(vecs))
        if cur is not None:
            stack.home = cur
            stack.written = torch.cuda.Event()
            stack.written.record(cur)
            stack.reads.clear()

    def _reading(self, stacks, launch):
        """Run ``launch()``, which enqueues kernels reading ``stacks``, on
        the current stream under the ordering rule of ``_scatter_chain``."""
        if self.device.type != "cuda":
            return launch()
        cur = torch.cuda.current_stream(self.device)
        away = [st for st in stacks if st.home is not None and st.home != cur]
        for st in away:
            if st.written is not None:
                cur.wait_event(st.written)
        out = launch()
        if away:
            ev = torch.cuda.Event()
            ev.record(cur)
            for st in away:
                st.reads[cur.cuda_stream] = ev
        return out

    def warm_sync(self, index: str) -> int:
        """Sync every RESIDENT stack of ``index`` to host truth, the device
        half of the ingest pipeline.  A stack no query asked for is never
        built here.  Returns the stacks visited."""
        with self._stacks_lock:
            keys = [k for k in self._stacks if k[0] == index]
            canonical = self.canonical_shards(index)
            n = 0
            for key in keys:
                if key in self._stacks:
                    self.field_stack(*key, canonical)
                    n += 1
            return n

    def ingest_syncer(self) -> IngestSyncer:
        """The engine's ingest sync worker, made at first use.  Nothing in
        the port calls ``notify`` yet: the caller that imports does."""
        with self._stacks_lock:
            if self._ingest_syncer is None:
                self._ingest_syncer = IngestSyncer(self)
            return self._ingest_syncer

    # -- warm start (pilosa_tpu/parallel/engine.py:1510) --------------------

    def warm_start(self, indexes=None) -> dict:
        """Upload the field stacks of the just-opened holder to the card
        while the node already answers queries (the Server runs this on a
        thread of its own).  Progress lands in ``self.warm_state``
        ({total, built, skipped, done}), which /readyz reports as
        ``warming`` until done.  Hot tenants go first (``_index_cost``, the
        plan ledger's cost EWMA, which the server persists across
        restarts), so the indexes traffic hits become resident before cold
        ones; warming stops at the working-set target
        (``warm_target_bytes``, a fraction of the budget,
        pilosa_tpu/parallel/engine.py:1677-1683) and skips a stack the
        card's free memory (``torch.cuda.mem_get_info``) cannot hold, so
        queries admit their own working set in the headroom.  Warming
        never evicts.  What waits: the prefetch thread that assembles
        stack N+1 on the host while stack N uploads."""
        keys = []
        index_list = list(indexes if indexes is not None else self.holder.indexes)
        index_list.sort(key=lambda i: -self._index_cost(i))
        for index in index_list:
            idx = self.holder.index(index)
            if idx is None or not self.canonical_shards(index):
                continue
            for fname, f in list(idx.fields.items()):
                for vname in list(f.views):
                    keys.append((index, fname, vname))
        state = {"total": len(keys), "built": 0, "skipped": 0, "done": False}
        self.warm_state = state
        for key in keys:
            if key in self._stacks:
                state["built"] += 1  # a query built it first
                continue
            need = self._stack_bytes(*key)
            with self._stacks_lock:
                used = (self._resident_bytes + self._pending_bytes()
                        + self.residency.inflight_bytes())
            if used + need > self.warm_target_bytes():
                break  # the target: the rest stays in the host tier
            if not self._card_fits(need):
                continue
            try:
                built = self.field_stack(*key) is not None
            except HostFallback:
                built = False  # the budget filled meanwhile: a query admits it
            if built:
                state["built"] += 1
                self._promotions_warm_counter.inc()
                self.journal.append("engine.promotion", index=key[0], field=key[1],
                                    view=key[2], cause="warm_start", partial=False,
                                    bytes=need)
        state["skipped"] = state["total"] - state["built"]
        state["done"] = True
        return state

    def warm_target_bytes(self) -> int:
        return int(self.max_resident_bytes * self.WARM_TARGET_FRACTION)

    def _stack_bytes(self, index: str, field: str, view: str) -> int:
        """The budget charge of a view's full stack."""
        canonical = self.canonical_shards(index)
        rows = self._row_universe(index, field, view, canonical)
        return max(1, len(rows)) * len(canonical) * ROW_SHARD_BYTES

    def _card_fits(self, need: int) -> bool:
        """Whether the card's free memory holds ``need`` bytes now."""
        if self.device.type != "cuda":
            return True
        free, _ = torch.cuda.mem_get_info(self.device)
        return need <= free

    def close(self):
        """Stop the residency worker, the ingest worker and the batcher,
        and drop every cached device buffer and memo entry.  A closed
        engine still serves: its caches (a batcher, a residency worker)
        rebuild."""
        self._closed = True
        self.residency.close()
        syncer, self._ingest_syncer = self._ingest_syncer, None
        if syncer is not None:
            syncer.close()
        with self._batcher_lock:
            batcher, self._batcher = self._batcher, None
        if batcher is not None:
            batcher.stop()
        with self._stacks_lock:
            self._stacks.clear()
            self._resident_bytes = 0
            self._pending_free = []
            self._masks.clear()
            self._topn_cands.clear()
            self._fused_plans.clear()
            self._universe_blocks_at.clear()
            self.result_memo.clear()
            self.repairs.clear()
            self.residency = residency_mod.ResidencyManager(self)
            self._closed = False

    # -- call-tree lowering -------------------------------------------------

    def _lower(self, index: str, c: Call, lw: _Lowering):
        """Lower a bitmap call tree to a normalized count program."""
        name = c.name
        if name == "Row":
            try:
                field_name = c.field_arg()
                row_id, ok = c.uint_arg(field_name)
            except ValueError as e:  # the host lane reports the argument error
                raise UnsupportedLowering(str(e)) from None
            if not ok:
                raise UnsupportedLowering("Row() requires a row id")
            return self._lower_row(index, field_name, row_id, lw)
        if name in ("Union", "Intersect", "Difference", "Xor"):
            op = {"Union": "or", "Intersect": "and", "Difference": "andnot",
                  "Xor": "xor"}[name]
            subs = tuple(self._lower(index, ch, lw) for ch in c.children)
            if not subs:
                return self._lower_zero()
            return (op,) + subs
        if name == "Not":
            if len(c.children) != 1:
                raise UnsupportedLowering("Not() requires a single input row")
            exist = self._lower_row(index, EXISTENCE_FIELD_NAME, 0, lw)
            return ("andnot", exist, self._lower(index, c.children[0], lw))
        if name == "Range" and c.has_condition_arg():
            return self._lower_range(index, c, lw)
        if name == "Range":
            return self._lower_time_range(index, c, lw)
        raise UnsupportedLowering(f"no device lowering for {name}()")

    @staticmethod
    def _lower_zero():
        return ("zero",)

    def _lower_row(self, index, field, row_id, lw: _Lowering):
        # A missing FIELD is the host lane's FieldNotFound error; the
        # existence field is exempt (an index without existence tracking
        # contributes zeros to Not()).
        idx_obj = self.holder.index(index)
        if field != EXISTENCE_FIELD_NAME and (
            idx_obj is None or idx_obj.field(field) is None
        ):
            raise UnsupportedLowering(f"field not found: {field!r}")
        stack = lw.stack_for(index, field, VIEW_STANDARD)
        if stack is None:
            return self._lower_zero()
        return self._row_leaf(index, field, VIEW_STANDARD, stack, row_id, lw)

    def _row_leaf(self, index, field, view, stack: _FieldStack, row_id, lw: _Lowering):
        """The leaf of one row of a stack: a stack row, a pool row (the
        all-zero slot vector for a row known empty), or zero for a row the
        stack lacks.  A row outside a partial stack's working set is not
        known to be empty: it misses (``_partial_miss`` raises)."""
        ridx = stack.row_index.get(row_id)
        if ridx is None and stack.partial and row_id not in stack.absent_rows:
            self._partial_miss(index, field, view, row_id, lw, stack)
        if stack.pool:
            p = lw.add_matrix(stack)
            return ("rowb", p, p + 1, stack.slot_vec(row_id))
        if ridx is None:
            return self._lower_zero()
        return ("row", lw.add_matrix(stack), ridx)

    # -- BSI and time-quantum Range (pilosa_tpu/parallel/engine.py:2383-2558)

    def _bsi_group(self, index: str, field_name: str):
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx is not None else None
        return f.bsi_group(field_name) if f is not None else None

    @staticmethod
    def _plane_spec(stack: _FieldStack, depth: int) -> Tuple[int, ...]:
        """The stack rows of BSI planes 0..depth (the not-null plane last),
        -1 for a plane the stack lacks."""
        return tuple(stack.row_index.get(r, -1) for r in range(depth + 1))

    def _lower_range(self, index: str, c: Call, lw: _Lowering):
        """A BSI Range condition: one range leaf, with the special cases
        of the host lane (executor.go:1309-1440): ``!= null`` and a bound
        past min/max or a BETWEEN covering [min, max] are the not-null
        row, an out-of-range predicate is zero.  A malformed condition is
        UnsupportedLowering: the host lane reports its error."""
        if len(c.args) != 1:
            raise UnsupportedLowering("Range() takes one condition")
        (field_name, cond), = c.args.items()
        if not isinstance(cond, Condition):
            raise UnsupportedLowering("Range(): expected a condition argument")
        bsig = self._bsi_group(index, field_name)
        if bsig is None:
            raise UnsupportedLowering(f"field not found: {field_name!r}")
        depth = bsig.bit_depth()
        stack = lw.stack_for(index, field_name, view_bsi_name(field_name))
        if stack is None:
            return self._lower_zero()
        # A predicate reads every plane: a partial stack cannot serve it.
        self._require_full_stack(index, field_name, view_bsi_name(field_name), stack)
        slot = lw.add_matrix(stack)
        planes = self._plane_spec(stack, depth)

        def not_null():
            return self._lower_zero() if planes[depth] < 0 else ("row", slot, planes[depth])

        if cond.op == NEQ and cond.value is None:
            return not_null()
        if cond.op == BETWEEN:
            try:
                bounds = cond.int_slice_value()
            except (TypeError, ValueError):
                raise UnsupportedLowering("Range(): BETWEEN takes two integers") from None
            if len(bounds) != 2:
                raise UnsupportedLowering("Range(): BETWEEN takes two integers")
            lo, hi, out_of_range = bsig.base_value_between(*bounds)
            if out_of_range:
                return self._lower_zero()
            if bounds[0] <= bsig.min and bounds[1] >= bsig.max:
                return not_null()
            return ("range", "between", slot, planes, lo, hi)
        value = cond.value
        kind = {EQ: "eq", NEQ: "neq", LT: "lt", LTE: "lte", GT: "gt", GTE: "gte"}.get(cond.op)
        if kind is None or not isinstance(value, int) or isinstance(value, bool):
            raise UnsupportedLowering("Range(): conditions only support integer values")
        base, out_of_range = bsig.base_value(cond.op, value)
        if out_of_range and cond.op != NEQ:
            return self._lower_zero()
        if ((cond.op == LT and value > bsig.max) or (cond.op == LTE and value >= bsig.max)
                or (cond.op == GT and value < bsig.min) or (cond.op == GTE and value <= bsig.min)
                or (out_of_range and cond.op == NEQ)):
            return not_null()
        return ("range", kind, slot, planes, base, 0)

    def _lower_time_range(self, index: str, c: Call, lw: _Lowering):
        """Time-quantum Range: the OR of the row over the minimal view cover
        (executor.go executeRangeShard :1233-1307), one row leaf per view
        stack, in the same launch.  A cover past the kernels' leaf table
        declines at dispatch (UnsupportedLowering), to the host lane."""
        try:
            field_name = c.field_arg()
            row_id, ok = c.uint_arg(field_name)
        except ValueError as e:
            raise UnsupportedLowering(str(e)) from None
        if not ok:
            raise UnsupportedLowering("Range() requires a row id")
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx is not None else None
        if f is None:
            raise UnsupportedLowering(f"field not found: {field_name!r}")
        start_str, end_str = c.args.get("_start"), c.args.get("_end")
        if not isinstance(start_str, str) or not isinstance(end_str, str):
            raise UnsupportedLowering("Range() time bounds required")
        try:
            start = timequantum.parse_timestamp(start_str)
            end = timequantum.parse_timestamp(end_str)
        except ValueError:
            raise UnsupportedLowering("cannot parse Range() time") from None
        q = f.time_quantum()
        if not q:
            return self._lower_zero()
        leaves = []
        for view_name in timequantum.views_by_time_range(VIEW_STANDARD, start, end, q):
            if f.view(view_name) is None:
                continue
            stack = lw.stack_for(index, field_name, view_name)
            if stack is None:
                continue
            leaf = self._row_leaf(index, field_name, view_name, stack, row_id, lw)
            if leaf[0] != "zero":
                leaves.append(leaf)
        if not leaves:
            return self._lower_zero()
        return leaves[0] if len(leaves) == 1 else ("or",) + tuple(leaves)

    def _collect_row_hints(self, index: str, c: Call, out=None) -> dict:
        """(index, field, view) -> the row ids the lowered tree will read
        there (None: the whole stack), by the leaf walk of ``_lower`` without
        fetching a stack (pilosa_tpu/parallel/engine.py:2560).  Collected
        before lowering, so that a miss requests ONE promotion of the whole
        query's working set.  Advisory: a shape the walk does not know marks
        nothing, and the lowering reports real errors."""
        if out is None:
            out = {}

        def add(field, view, row_id):
            key = (index, field, view)
            cur = out.get(key, ())
            if cur is None:
                return  # the whole stack is required already
            rows = cur if cur != () else set()
            rows.add(int(row_id))
            out[key] = rows

        try:
            name = c.name
            if name == "Row":
                field = c.field_arg()
                row_id, ok = c.uint_arg(field)
                if ok:
                    add(field, VIEW_STANDARD, row_id)
            elif name == "Not":
                add(EXISTENCE_FIELD_NAME, VIEW_STANDARD, 0)
                for ch in c.children:
                    self._collect_row_hints(index, ch, out)
            elif name in ("Union", "Intersect", "Difference", "Xor"):
                for ch in c.children:
                    self._collect_row_hints(index, ch, out)
            elif name == "Range" and c.has_condition_arg():
                (field, _cond), = c.args.items()
                out[(index, field, view_bsi_name(field))] = None
            elif name == "Range":
                field = c.field_arg()
                row_id, ok = c.uint_arg(field)
                idx = self.holder.index(index)
                f = idx.field(field) if idx is not None else None
                if ok and f is not None and f.time_quantum():
                    start = timequantum.parse_timestamp(c.args["_start"])
                    end = timequantum.parse_timestamp(c.args["_end"])
                    for vname in timequantum.views_by_time_range(VIEW_STANDARD, start, end,
                                                                 f.time_quantum()):
                        add(field, vname, row_id)
        except Exception:  # noqa: BLE001 — hints are advisory only
            pass
        return out

    # -- fused evaluation ---------------------------------------------------

    def count(self, index: str, c: Call, shards: List[int], memo_key=_MEMO_UNSET) -> int:
        """Count(tree): one kernel launch and one readback, or a result-memo
        hit with neither.  ``memo_key`` hands through the key of a caller
        that probed the memo already (the batcher's direct path)."""
        key, hit = self._memo_lookup(index, c, shards, memo_key)
        if hit is not None:
            return int(hit)
        canonical = self.canonical_shards(index)
        if not canonical:
            return 0
        v = int(self._dispatch_count(index, c, shards, canonical))
        self.result_memo.put(key, v)
        if key is not None:
            self.repairs.register_count(key, c, v)
        return v

    def count_async(self, index: str, c: Call, shards: List[int],
                    memo_key=_MEMO_UNSET) -> torch.Tensor:
        """Count(tree) as a 0-d int64 device tensor, without waiting for
        the device.  A repeat of this (query, shards) against unchanged
        views is answered from the result memo with no launch; the memo
        keeps the device scalar itself, so a later hit hands the same
        tensor back.  After a write, a miss that the repair layer serves
        (``memo_probe``) comes back as a host int, put on the card here;
        a fresh result registers for repair with the device scalar held
        lazily (the first repair reads it back, never this thread)."""
        key, hit = self._memo_lookup(index, c, shards, memo_key)
        if hit is not None:
            if isinstance(hit, torch.Tensor):
                return hit
            return torch.tensor(int(hit), dtype=torch.int64, device=self.device)
        canonical = self.canonical_shards(index)
        if not canonical:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        dev = self._dispatch_count(index, c, shards, canonical)
        self.result_memo.put(key, dev)
        if key is not None:
            self.repairs.register_count(key, c, dev)
        return dev

    def _memo_lookup(self, index, c, shards, memo_key):
        """(key, hit-or-None): ``memo_probe``, unless the caller probed
        already and passed its key (a known miss)."""
        if memo_key is not _MEMO_UNSET:
            return memo_key, None
        return self.memo_probe(index, c, shards)

    # -- result memo (pilosa_tpu/parallel/engine.py:2695-2830) -------------
    #
    # A miss probes the repair layer (``self.repairs.probe``), which answers
    # a repeat after a write from the write's delta with no launch.

    # Call names whose referenced fields _collect_fields can enumerate:
    # what the engine lowers (lowerable), so every fused Count is eligible.
    _MEMO_CALLS = frozenset(("Row", "Union", "Intersect", "Difference", "Xor", "Not", "Range"))

    def _collect_fields(self, c: Call, out=None):
        """Every field a tree reads, or None when the tree has a shape the
        walk does not understand (no memo then: correctness first)."""
        if out is None:
            out = set()
        if c.name not in self._MEMO_CALLS:
            return None
        if c.name == "Row" or (c.name == "Range" and not c.has_condition_arg()):
            try:
                out.add(c.field_arg())
            except ValueError:
                return None
        elif c.name == "Range":  # a BSI condition: its field is the key
            out.update(k for k, v in c.args.items() if isinstance(v, Condition))
        if c.name == "Not":
            out.add(EXISTENCE_FIELD_NAME)
        for ch in c.children:
            if self._collect_fields(ch, out) is None:
                return None
        return out

    def _memo_key(self, index: str, c: Call, shards):
        """Result-memo key: (index, query text, shard set, version tokens
        of EVERY view of every referenced field).  The tokens mirror the
        stack token of ``field_stack`` — (shard epoch, view generation,
        view version) — so any write that would stale a resident stack
        also stales every memo entry over it, at no write-path cost.  None
        when the tree is not walkable or the memo is off."""
        if self.result_memo.maxsize <= 0:
            return None
        ent = self._memo_sig_cache.get(id(c))
        if ent is not None and ent[0] is c:
            ent[3] = True  # second-chance reference bit (GIL-atomic)
            qstr, fields = ent[1], ent[2]
        else:
            fields = self._collect_fields(c)
            if fields is None:
                return None
            qstr = str(c)
            self._memo_sig_insert(c, qstr, fields)
        toks = self.memo_tokens(index, fields)
        if toks is None:
            return None
        return (index, qstr, tuple(sorted(set(shards))), toks)

    _SIG_CACHE_MAX = 1024

    def _memo_sig_insert(self, c, qstr, fields):
        """Admit a tree signature under second-chance eviction: a full
        cache evicts the oldest UNREFERENCED half and clears the
        survivors' reference bits, so a hot repeat keeps its entry."""
        with self._memo_sig_lock:
            cache = self._memo_sig_cache
            if len(cache) >= self._SIG_CACHE_MAX:
                need = self._SIG_CACHE_MAX // 2
                survivors: Dict[int, list] = {}
                evicted = 0
                for k, ent in cache.items():
                    if evicted < need and not ent[3]:
                        evicted += 1
                        continue
                    ent[3] = False
                    survivors[k] = ent
                if evicted < need:
                    # Everything was referenced: drop the oldest anyway.
                    for k in list(survivors)[: need - evicted]:
                        del survivors[k]
                self._memo_sig_cache = survivors
            self._memo_sig_cache[id(c)] = [c, qstr, fields, False]

    def memo_tokens(self, index: str, fields):
        """Version tokens over every view of ``fields``: the index's shard
        epoch, then (field, view, generation, version) per view.  None when
        the index is unknown or a concurrent writer grew a view dict
        mid-walk."""
        idx_obj = self.holder.index(index)
        if idx_obj is None:
            return None
        toks: list = [self.holder.shard_epoch(index)]
        try:
            for fname in sorted(fields):
                f = idx_obj.field(fname)
                if f is None:
                    toks.append((fname, None))
                    continue
                for vname in sorted(f.views):
                    v = f.views[vname]
                    toks.append((fname, vname, v.gen, v.version))
        except RuntimeError:
            # A first write to a new view grew the dict mid-walk: skip the
            # memo for this query rather than fail the read.
            return None
        return tuple(toks)

    def memo_probe(self, index: str, c: Call, shards):
        """(key, value-or-None) for the batcher's submit fast path: a hit
        answers the Count before it touches the queue or the card.  The
        key goes back to the caller so that the eventual result is stored
        under the tokens read AT SUBMIT TIME: a write landing mid-flight
        keys its readers to new tokens, so the entry can only be served to
        queries that began before the write."""
        key = self._memo_key(index, c, shards)
        if key is None:
            return None, None
        return key, self._memo_get("count", key, "result_memo")

    def _memo_get(self, kind: Optional[str], key, tag: str):
        """The memo's value for ``key``, a hit or miss of cache ``tag``; on
        a miss, the repair layer's ``kind`` entry advanced to the key's
        tokens (None: no repair)."""
        v = self.result_memo.get(key)
        if v is not None:
            self._cache_hit(tag)
            return v
        self._cache_miss(tag)
        return None if kind is None else self.repairs.probe(kind, key)

    def memo_store(self, key, value, call=None):
        """Store a result under a key from ``memo_probe``; with ``call``,
        register its footprint for repair-on-write too."""
        self.result_memo.put(key, value)
        if call is not None and key is not None and value is not None:
            self.repairs.register_count(key, call, value)

    def memo_probe_groupby(self, index, c_str, fields, filter_call, shards):
        """(key, counts-or-None) for the fused GroupBy lane.  The value is
        the SHAPED count array, not the assembled result: the executor
        re-runs its limit/offset assembly over it, so a hit cannot drift
        from a recompute.  The tokens cover the group fields and the
        filter's fields; the row lists derive from the group fields'
        standard views, so unchanged tokens pin the array's axes too."""
        if self.result_memo.maxsize <= 0:
            return None, None
        tfields = set(fields)
        if filter_call is not None:
            ffields = self._collect_fields(filter_call)
            if ffields is None:
                return None, None
            tfields |= ffields
        toks = self.memo_tokens(index, tfields)
        if toks is None:
            return None, None
        key = (index, "groupby:" + c_str, tuple(sorted(set(shards))), toks)
        return key, self._memo_get("groupby", key, "memo_groupby")

    def memo_store_groupby(self, key, fields, row_lists, filter_call, counts):
        """Store a GroupBy's counts, shaped [K_1, ..., K_n], under a key
        from ``memo_probe_groupby``, and register them for repair."""
        if key is None or counts is None:
            return
        shaped = np.asarray(counts, dtype=np.int64).reshape(
            tuple(len(rows) for rows in row_lists))
        self.result_memo.put(key, shaped)
        self.repairs.register_groupby(key, fields, row_lists, filter_call, shaped)

    def memo_probe_topn(self, index, field_name, shards, n, threshold, row_ids):
        """(key, pairs-or-None) for the cache-only TopN lane: signed by
        the field and the rank parameters, tokened over every view of the
        field.  A miss probes the repair layer, whose count table is
        re-ranked with exactly topn_cache_only's host reduce."""
        if self.result_memo.maxsize <= 0:
            return None, None
        toks = self.memo_tokens(index, {field_name})
        if toks is None:
            return None, None
        qstr = "topn:%s|%d|%d|%s" % (
            field_name, n, threshold,
            ",".join(map(str, row_ids)) if row_ids else "",
        )
        key = (index, qstr, tuple(sorted(set(shards))), toks)
        v = self._memo_get("topn", key, "memo_topn")
        return key, (None if v is None else [tuple(p) for p in v])

    def memo_store_topn(self, key, field_name, n, threshold, row_ids, pairs):
        """Store a cache-only TopN's pairs under a key from
        ``memo_probe_topn`` and register its count table for repair."""
        if key is None or pairs is None:
            return
        self.result_memo.put(key, tuple(map(tuple, pairs)))
        self.repairs.register_topn(key, field_name, n, threshold, row_ids)

    @staticmethod
    def _operand_bytes(parts, mask_bytes: int = 0, slot_vector: bool = False,
                       pad_copies: int = 0, extra: int = 0) -> int:
        """The plan's ``bytes_touched`` of a dense launch: the device bytes
        the reference's dispatch over the same lowering passes as operands
        (``pilosa_tpu/parallel/engine.py:3068 _operand_bytes``), so that
        both packages' plans agree.  ``parts`` is a list of (lowering,
        programs): each distinct stack matrix of a lowering counts once (a
        pool's slot table, which the reference does not have, never; a
        missing stack as the reference's zero stack, uint32[1, S, WORDS],
        once per shard axis), an int32 row scalar per row leaf (in batch
        mode one int32 slot vector of at least one entry), an int32[64]
        slot vector per pool leaf and a range leaf's predicate bits
        (uint32[depth], two for BETWEEN); ``mask_bytes`` adds the uint32[S, 1]
        shard masks and ``extra`` the other replicated operands.
        ``pad_copies`` re-counts the first program's leaves that many
        times: the reference pads a batch to its tier by lowering query 0
        again."""
        total = extra + mask_bytes
        scalars = 0
        zero_axes = set()

        def walk(p, S):
            nonlocal total, scalars
            kind = p[0]
            if kind == "row":
                scalars += 1
            elif kind == "rowb":
                total += bitops.OCC_BLOCKS * 4
            elif kind == "range":
                # The reference's predicate bits: uint32[max(depth, 1)]
                # each, two for BETWEEN (its _bits_arr).
                total += 4 * max(len(p[3]) - 1, 1) * (2 if p[1] == "between" else 1)
            elif kind == "zero":
                if S not in zero_axes:
                    zero_axes.add(S)
                    total += S * bitops.WORDS * 4
            elif kind != "mref":
                for q in p[1:]:
                    walk(q, S)

        for lw, progs in parts:
            seen = set()
            for m, st in zip(lw.mats, lw.stacks):
                if id(m) in seen or (st.pool and m is st.slot_table):
                    continue
                seen.add(id(m))
                total += m.numel() * m.element_size()
            S = len(lw.canonical)
            for p in progs:
                walk(p, S)
            if pad_copies and progs:
                for _ in range(pad_copies):
                    walk(progs[0], S)
        return total + 4 * (max(1, scalars) if slot_vector else scalars)

    def _dispatch_count(self, index, c, shards, canonical):
        with self._stacks_lock:
            lw = _Lowering(self, canonical)
            lw.row_hints = self._collect_row_hints(index, c)
            prog = self._lower(index, c, lw)
            if not kernels.fits(prog):
                raise UnsupportedLowering("count tree exceeds the kernels' limits")
            plan = self._sparse_plan(prog, lw, shards, canonical)
            self._note_touches(lw)
            if plan is not None:
                return self._reading(lw.stacks,
                                     lambda: self._dispatch_sparse(prog, lw.mats, plan))
            self.dense_dispatches += 1
            self.last_path = "dense"
            if plans_mod.ENABLED:
                # K1 and K1P alike note the reference's dense count_tree record.
                plans_mod.note_dispatch(op="Count", path="dense", fused=True,
                                        bytes_touched=self._operand_bytes([(lw, (prog,))]))
            mask = self._mask_words(shards, canonical)
            return self._reading(lw.stacks, lambda: kernels.count_tree(prog, lw.mats, mask))

    def _dispatch_sparse(self, prog, mats, plan):
        blk_bits, skipped = plan
        self.sparse_dispatches += 1
        self.device_bytes_skipped += skipped
        self._bytes_skipped_counter.inc(skipped)
        self.last_path = "sparse"
        plans_mod.note_dispatch(op="Count", path="sparse", fused=True, bytes_skipped=skipped)
        bits = torch.from_numpy(blk_bits)
        if self.device.type == "cuda":
            # One pinned staging copy, queued behind the stream's work
            # without waiting for it.
            bits = bits.pin_memory().to(self.device, non_blocking=True)
        return sparse_mod.count_tree_blocks(prog, mats, bits)

    def _sparse_plan(self, prog, lw: _Lowering, shards, canonical):
        """The per-shard block words for the sparse count, or None to take
        the dense path.  Combines the stacks' occupancy summaries through
        the tree on the host (and intersects, or/xor unite, andnot keeps
        its left side — the right can only clear bits), zeroes the
        unrequested shards, and when the surviving block fraction is at or
        under ``sparse_threshold`` returns ``(blk_bits int64[S],
        bytes_skipped)``: bit b of word s set iff block b of shard s is
        read.  A tree with a pool leaf takes the dense path (there K1P
        reads only the tree's live blocks, the same in every shard), once
        the partial stack's invariant mask >= occ is checked: a violated
        one (structurally unreachable) sends the query to the host tier
        rather than count stale zeros
        (pilosa_tpu/parallel/engine.py:3150-3162)."""
        S = len(canonical)
        n_leaves = 0
        pooled = False

        def occ_of(p):
            nonlocal n_leaves, pooled
            kind = p[0]
            if kind == "zero":
                return np.zeros(S, dtype=np.uint64)
            if kind == "row":
                n_leaves += 1
                return lw.stacks[p[1]].occ[p[2]]
            if kind == "rowb":
                pooled = True
                st, ridx = lw.stacks[p[1]], p[3]
                if ridx >= st.occ.shape[0]:
                    return np.zeros(S, dtype=np.uint64)  # the all-zero vector
                if st.block_mask is not None and np.any(st.occ[ridx] & ~st.block_mask[ridx]):
                    raise ResidencyMiss("occupied blocks not device-resident on a partial stack")
                return st.occ[ridx]
            if kind == "range":
                # Every range condition is a subset of the not-null plane.
                planes = p[3]
                n_leaves += sum(1 for r in planes if r >= 0)
                if planes[-1] < 0:
                    return np.zeros(S, dtype=np.uint64)
                return lw.stacks[p[2]].occ[planes[-1]]
            subs = [occ_of(q) for q in p[1:]]
            occ = subs[0]
            for so in subs[1:]:
                if kind == "and":
                    occ = occ & so
                elif kind != "andnot":  # or / xor widen; andnot keeps left
                    occ = occ | so
            return occ

        occ = occ_of(prog)
        if n_leaves == 0 or pooled:
            return None
        pos = {s: i for i, s in enumerate(canonical)}
        req = np.zeros(S, dtype=bool)
        for s in shards:
            i = pos.get(s)
            if i is not None:
                req[i] = True
        n_req = int(req.sum())
        if n_req == 0:
            return None
        occ = np.where(req, occ, np.uint64(0))
        total_blocks = bitops.popcount_np(occ)
        denom = n_req * bitops.OCC_BLOCKS
        # The occupancy decision either way: the blocks that survive the
        # host-side combine against the dense sweep's, and the threshold.
        plans_mod.note_dispatch(blocks_surviving=total_blocks, blocks_total=denom,
                                occ_fraction=round(total_blocks / denom, 4),
                                threshold=self.sparse_threshold)
        if total_blocks / denom > self.sparse_threshold:
            return None
        block_bytes = bitops.OCC_BLOCK_WORDS * 4
        skipped = n_leaves * (denom - total_blocks) * block_bytes
        plans_mod.note_dispatch(bytes_touched=n_leaves * total_blocks * block_bytes)
        return occ.view(np.int64), skipped

    # -- batched Counts (pilosa_tpu/parallel/engine.py:3246-3386, 3719-3865)

    # The reference's batch program tiers: its plan records the tier a
    # batch pads to, and the plans of both packages carry it.
    BATCH_TIERS = (8, 64, 256, 512)

    _LOWERABLE = frozenset(("Row", "Union", "Intersect", "Difference", "Xor", "Not", "Range"))

    def lowerable(self, c: Call) -> bool:
        """Static pre-screen: every call name in the tree has a lowering.
        Argument errors (a missing row id, an unknown field) still surface
        at lowering; this keeps plainly host-lane calls out of batches."""
        if c.name not in self._LOWERABLE:
            return False
        return all(self.lowerable(ch) for ch in c.children)

    def count_many(self, index: str, calls, shards_list) -> List[int]:
        """K Count(tree) queries in one K5 launch and one readback;
        ``shards_list[i]`` is query i's requested shard subset."""
        return [int(v) for v in self.count_many_async(index, calls, shards_list).tolist()]

    def count_many_async(self, index: str, calls, shards_list) -> torch.Tensor:
        """``count_many`` as an int64[K] device tensor, without waiting for
        the device.  (The reference's multi-process replay of the batch,
        ``_collective``, is ROADMAP.md Queue 1 item 15.)"""
        if not calls:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        canonical = self.canonical_shards(index)
        if not canonical:
            return torch.zeros(len(calls), dtype=torch.int64, device=self.device)
        return self._dispatch_count_batch(index, calls, shards_list, canonical)

    def _dispatch_count_batch(self, index, calls, shards_list, canonical):
        # Batch CSE: identical (query text, shard set) entries — repeated
        # dashboards and pollers make them the common case — lower once
        # and K5 fans the answer back out to every caller slot.
        uniq: Dict[tuple, int] = {}
        mapping: List[int] = []
        u_calls: list = []
        u_shards: list = []
        for c, shards in zip(calls, shards_list):
            k = (str(c), tuple(shards))
            j = uniq.get(k)
            if j is None:
                j = uniq[k] = len(u_calls)
                u_calls.append(c)
                u_shards.append(shards)
                self._cache_miss("batch_cse")
            else:
                self._cache_hit("batch_cse")
            mapping.append(j)
        deduped = len(calls) - len(u_calls)
        self.batch_cse_deduped += deduped
        if len(u_calls) == 1:
            # One unique query takes the scalar path: K1, or K2 where the
            # sparse plan applies (K5 is dense by construction).
            plans_mod.note_dispatch(cse_unique=1, cse_deduped=deduped, batch_size=len(calls))
            dev = self._dispatch_count(index, u_calls[0], u_shards[0], canonical)
            return dev.reshape(1).expand(len(calls))
        with self._stacks_lock:
            lw = _Lowering(self, canonical)
            for c in u_calls:
                self._collect_row_hints(index, c, lw.row_hints)
            progs = []
            for c in u_calls:
                prog = self._lower(index, c, lw)
                if not kernels.fits(prog):
                    # K5 takes what K1 and K2 take: past that (ranges,
                    # ops, stack) the caller's host lane answers every
                    # Count of the batch.
                    self.batch_declines += len(calls)
                    raise UnsupportedLowering("count tree exceeds the kernels' limits")
                progs.append(prog)
            fan = mapping if deduped else None
            self._note_touches(lw)
            # The reference's record of its padded batch program: the tier
            # it pads to and the operands that program passes.
            if plans_mod.ENABLED:
                K = len(progs)
                K_pad = next((t for t in self.BATCH_TIERS if K <= t),
                             max(1, 1 << (K - 1).bit_length()))
                plans_mod.note_dispatch(
                    op="Count", path="dense_batch", fused=True, cse_unique=K,
                    cse_deduped=deduped, batch_size=len(calls), tier=K_pad,
                    bytes_touched=self._operand_bytes(
                        [(lw, progs)], slot_vector=True, pad_copies=K_pad - K,
                        mask_bytes=4 * len(canonical) * len({frozenset(s) for s in u_shards})))
            return self._launch_batch(progs, lw, u_shards, canonical, fan)

    def _launch_batch(self, progs, lw: _Lowering, shard_lists, canonical, fan):
        """K5 over lowered trees: one launch, or one per group past a
        launch's query or leaf-table limit; with ``fan`` the answers fanned
        out as ``result[fan]``."""
        masks, mask_ids = self._mask_table(shard_lists, canonical)
        groups = kernels.batch_groups(progs)
        self.batch_dispatches += len(groups)
        self.last_path = "batch"
        if len(groups) == 1:
            return self._reading(lw.stacks, lambda: kernels.count_batch_tree(
                progs, lw.mats, masks, mask_ids, self.device, fan))
        out = torch.cat([
            self._reading(lw.stacks, lambda a=a, b=b: kernels.count_batch_tree(
                progs[a:b], lw.mats, masks, mask_ids[a:b], self.device))
            for a, b in groups])
        if fan is not None:
            out = out[torch.as_tensor(fan, dtype=torch.int64).to(self.device)]
        return out

    def _mask_table(self, shard_lists, canonical):
        """(bool[M, S] distinct requested-shard masks over the canonical
        axis, mask id per query)."""
        canon = np.asarray(canonical, dtype=np.int64)
        ids: Dict[tuple, int] = {}
        rows: List[np.ndarray] = []
        mask_ids = []
        for shards in shard_lists:
            k = tuple(shards)
            i = ids.get(k)
            if i is None:
                i = ids[k] = len(rows)
                rows.append(np.isin(canon, np.asarray(k, dtype=np.int64)))
            mask_ids.append(i)
        return np.stack(rows), mask_ids

    _EXPLAIN_NARY = {"Intersect": "and", "Union": "or", "Difference": "andnot", "Xor": "xor"}

    def explain_count(self, index: str, c: Call, shards) -> dict:
        """Plan a Count WITHOUT launching anything: the PQL ``Explain(...)``
        dry-run (pilosa_tpu/parallel/engine.py:3263-3351).  Combines the
        per-(row, shard) block occupancy straight from the HOST fragments
        (no stack is built or promoted), probes the result memo without
        touching it, and reports the path a real dispatch would take."""
        canonical = self.canonical_shards(index)
        doc: dict = {
            "op": "Count",
            "query": str(c),
            "lowerable": self.lowerable(c),
            "shards": len(shards),
            "canonicalShards": len(canonical),
        }
        key = self._memo_key(index, c, shards)
        hit = self.result_memo.peek(key)
        doc["memo"] = "hit" if hit else "miss"
        if not hit:
            doc["memoReason"] = self.result_memo.miss_reason(key)
        if not doc["lowerable"] or not canonical:
            doc["plannedPath"] = "host" if not doc["lowerable"] else "empty"
            return doc
        block_bytes = bitops.OCC_BLOCK_WORDS * 4
        shard_set = set(shards)
        n_req = sum(1 for s in canonical if s in shard_set)

        class _NotSparse(Exception):
            pass

        def occ_of(call) -> np.ndarray:
            if call.name == "Row" and not call.children and len(call.args) == 1:
                (fname, row), = call.args.items()
                if isinstance(row, bool) or not isinstance(row, int):
                    raise _NotSparse
                out = np.zeros(len(canonical), dtype=np.uint64)
                for i, s in enumerate(canonical):
                    if s not in shard_set:
                        continue
                    frag = self.holder.fragment(index, fname, VIEW_STANDARD, s)
                    if frag is not None:
                        out[i] = np.uint64(frag.row_occupancy(row))
                return out
            kind = self._EXPLAIN_NARY.get(call.name)
            if kind is None or not call.children:
                raise _NotSparse
            occ = occ_of(call.children[0])
            for ch in call.children[1:]:
                so = occ_of(ch)
                if kind == "and":
                    occ = occ & so
                elif kind != "andnot":  # or/xor widen; andnot keeps left
                    occ = occ | so
            return occ

        def leaves(call) -> int:
            if call.name == "Row":
                return 1
            return sum(leaves(ch) for ch in call.children)

        try:
            occ = occ_of(c)
        except _NotSparse:
            doc["plannedPath"] = "dense"
            doc["sparseEligible"] = False
            return doc
        surviving = bitops.popcount_np(occ)
        total = max(1, n_req * bitops.OCC_BLOCKS)
        frac = surviving / total
        sparse = frac <= self.sparse_threshold
        n_leaves = leaves(c)
        doc.update(
            sparseEligible=True,
            blocksSurviving=surviving,
            blocksTotal=total,
            occFraction=round(frac, 4),
            sparseThreshold=self.sparse_threshold,
            plannedPath="memo" if hit else ("sparse" if sparse else "dense"),
            estBytesDense=n_leaves * total * block_bytes,
            estBytesSkipped=n_leaves * (total - surviving) * block_bytes if sparse else 0,
        )
        return doc

    def batcher(self):
        """The cross-request micro-batcher (``batcher.py``), made at first
        use."""
        if self._batcher is None:
            with self._batcher_lock:
                if self._batcher is None:
                    from .batcher import CountBatcher

                    self._batcher = CountBatcher(self)
        return self._batcher

    def batched_count(self, index: str, c: Call, shards) -> int:
        """Count(tree) through the batcher: a lone caller runs the plain
        path; concurrent callers drain into one K5 launch."""
        return self.batcher().submit(index, c, shards)

    def batched_count_async(self, index: str, c: Call, shards):
        """Count(tree) queued into the batcher's bounded pipeline; returns
        its future (``_Item``: wait/result/error/add_done_callback)
        without blocking."""
        return self.batcher().submit_async(index, c, shards)

    def pipeline_snapshot(self):
        """The batcher's pipeline telemetry (None before the first batched
        query makes the batcher)."""
        if self._batcher is None:
            return None
        return self._batcher.pipeline_snapshot()

    # -- TopN (pilosa_tpu/parallel/engine.py:4102-4565) ---------------------

    def _lower_src(self, index: str, src_call: Call, canonical: List[int]):
        """The src tree of a TopN as a normalized program and its stacks;
        a tree past the kernels' limits is UnsupportedLowering."""
        lw = _Lowering(self, canonical)
        lw.row_hints = self._collect_row_hints(index, src_call)
        prog = self._lower(index, src_call, lw)
        if not kernels.fits(prog):
            raise UnsupportedLowering("src tree exceeds the kernels' limits")
        return prog, lw

    def topn_scores_async(self, index: str, field: str, candidate_rows: List[int],
                          src_call: Call, shards: List[int]):
        """TopN phase 1 as one K3 launch, without waiting for the device:
        ([scores int32[K, S], src_counts int32[S]], decoder), the decoder
        giving ``topn_scores``' result from their host arrays, or None
        when the field has no stack."""
        canonical = self.canonical_shards(index)
        with self._stacks_lock:
            stack = self._require_full_stack(
                index, field, VIEW_STANDARD,
                self.field_stack(index, field, VIEW_STANDARD, canonical))
            if stack is None:
                return None
            present = np.asarray([r in stack.row_index for r in candidate_rows], dtype=bool)
            idx = np.asarray(
                [stack.row_index.get(r, 0) for r in candidate_rows], dtype=np.int32
            )
            mask = self._mask_words(shards, canonical)
            prog, lw = self._lower_src(index, src_call, canonical)
            cand_idx = torch.from_numpy(idx).to(self.device)
            scores, counts = self._reading(
                lw.stacks + [stack],
                lambda: kernels.topn_tree(prog, lw.mats, mask, stack.matrix, cand_idx))
        pos = {s: i for i, s in enumerate(stack.shards)}
        return [scores, counts], fusion_mod._TopNScoresDecode(present, pos)

    def topn_scores(self, index: str, field: str, candidate_rows: List[int],
                    src_call: Call, shards: List[int]):
        """Batched TopN phase-1 scoring across all requested shards in one
        K3 launch: (scores int32[S, K], src_counts int32[S], shard_pos) as
        numpy, ``shard_pos`` mapping shard -> canonical position.
        Candidates absent from the row table score 0 (they read row 0 on
        the card and are zeroed here).  None when the field has no stack."""
        res = self.topn_scores_async(index, field, candidate_rows, src_call, shards)
        if res is None:
            return None
        tensors, dec = res
        return dec([t.cpu().numpy() for t in tensors])

    def _build_topn_candidates(self, index, field, stack, cands) -> _TopNCandidates:
        """Assemble the id-descending candidate arrays for a stack."""
        S = len(stack.shards)
        K = len(cands)
        K_pad = max(8, 1 << (K - 1).bit_length()) if K else 8
        host_cnt = np.zeros((S, K_pad), dtype=np.int32)
        if K:
            cand_arr = np.asarray(cands, dtype=np.int64)
            for si, s in enumerate(stack.shards):
                frag = self.holder.fragment(index, field, VIEW_STANDARD, s)
                if frag is not None:
                    host_cnt[si, :K] = frag.counts_for(cand_arr).astype(np.int32)
        idx = np.zeros(K_pad, dtype=np.int32)
        idx[:K] = [stack.row_index.get(r, 0) for r in cands]
        return _TopNCandidates(
            list(cands),
            torch.from_numpy(idx).to(self.device),
            torch.from_numpy(host_cnt.T.copy()).to(self.device),
            host_cnt,
        )

    def _topn_candidates(self, index, field, stack, row_ids=None) -> _TopNCandidates:
        """Cached candidate arrays (the union of every shard's ranked-cache
        ids); explicit ids= queries build ad hoc."""
        if row_ids:
            return self._build_topn_candidates(
                index, field, stack, sorted(set(row_ids), reverse=True)
            )
        key = (index, field)
        cached = self._topn_cands.get(key)
        if cached is not None and cached[0] == stack.versions:
            return cached[1]
        cols = []
        for s in stack.shards:
            frag = self.holder.fragment(index, field, VIEW_STANDARD, s)
            if frag is None:
                continue
            rank_columns = getattr(frag.cache, "rank_columns", None)
            if rank_columns is not None:
                cols.append(rank_columns()[0])
            elif frag.cache.top():
                cols.append(np.asarray([r for r, _ in frag.cache.top()], dtype=np.int64))
        cands = [int(r) for r in np.unique(np.concatenate(cols))[::-1]] if cols else []
        entry = self._build_topn_candidates(index, field, stack, cands)
        self._topn_cands[key] = (stack.versions, entry)
        return entry

    def topn_full_async(self, index: str, field: str, src_call: Call, shards,
                        n: int, min_threshold: int, row_ids=None):
        """The whole TopN (phase-1 scores, per-shard gates, exact totals
        and the trim) as one K3 launch, without waiting for the device:
        (candidates, n_out, device result: int32[2, n_out] or the int64[K]
        totals), or None when the candidate union is past
        MAX_TOPN_CANDIDATES (the two-phase path runs)."""
        canonical = self.canonical_shards(index)
        with self._stacks_lock:
            stack = self._require_full_stack(
                index, field, VIEW_STANDARD,
                self.field_stack(index, field, VIEW_STANDARD, canonical))
            if stack is None:
                return [], None, None
            entry = self._topn_candidates(index, field, stack, row_ids)
            if not entry.cands:
                return [], None, None
            if len(entry.cands) > self.MAX_TOPN_CANDIDATES:
                return None
            # ids= mode and n=0 skip the trim (never truncate).
            K_pad = entry.host_cnt.shape[1]
            n_out = min(int(n), K_pad) if n and not row_ids else None
            mask = self._mask_words(shards, canonical)
            prog, lw = self._lower_src(index, src_call, canonical)
            out = self._reading(lw.stacks + [stack], lambda: kernels.topn_full_tree(
                prog, lw.mats, mask, stack.matrix, entry.cand_idx, entry.dev_cnt,
                max(int(min_threshold), 1), n_out,
            ))
            return entry.cands, n_out, out

    def topn_full(self, index: str, field: str, src_call: Call, shards,
                  n: int, min_threshold: int, row_ids=None):
        """Synchronous fused TopN -> sorted (row_id, count) pairs, one small
        readback, or None when the fused path declines."""
        res = self.topn_full_async(index, field, src_call, shards, n, min_threshold, row_ids)
        if res is None:
            return None
        cands, n_out, out = res
        host = None if out is None else out.cpu().numpy()
        if host is not None and n_out is not None:
            host = (host[0], host[1])
        return decode_topn_full(host, cands, n_out)

    def topn_cache_only(self, index: str, field: str, shards, n, min_threshold,
                        row_ids=None):
        """TopN with no src bitmap: the per-shard store counts of the
        candidates, reduced on the host (phase-1 per-shard top-n union plus
        phase-2 exact totals over the requested shards), no device work.
        Sorted trimmed pairs, or None when the candidate union is too
        large."""
        canonical = self.canonical_shards(index)
        with self._stacks_lock:
            stack = self._require_full_stack(
                index, field, VIEW_STANDARD,
                self.field_stack(index, field, VIEW_STANDARD, canonical))
        if stack is None:
            return []
        entry = self._topn_candidates(index, field, stack, row_ids)
        if row_ids:
            n = 0  # explicit ids: never truncate
        K = len(entry.cands)
        if K == 0:
            return []
        if K > self.MAX_TOPN_CANDIDATES:
            return None
        pos = {s: i for i, s in enumerate(stack.shards)}
        rows = [pos[s] for s in shards if s in pos]
        if not rows:
            return []
        thr = max(int(min_threshold), 1)
        cnt = entry.host_cnt[np.asarray(rows, dtype=np.intp)][:, :K]
        gated = np.where(cnt >= thr, cnt, 0)
        totals = gated.sum(axis=0, dtype=np.int64)
        if n:
            # Phase-1 candidate union: each shard's top-n by (count desc,
            # id desc) — a stable argsort over the id-descending axis.
            sel = np.argsort(-gated, axis=1, kind="stable")[:, : int(n)]
            hit = np.nonzero(np.take_along_axis(gated, sel, axis=1) > 0)
            union = np.zeros(K, dtype=bool)
            union[sel[hit]] = True
        else:
            union = (gated > 0).any(axis=0)
        pairs = [
            (entry.cands[k], int(totals[k]))
            for k in np.nonzero(union)[0]
            if totals[k] > 0
        ]
        pairs.sort(key=pair_sort_key)
        if n:
            pairs = pairs[: int(n)]
        return pairs

    # -- BSI Sum, Min, Max (pilosa_tpu/parallel/engine.py:3953-4100) -------
    #
    # The reference replays these across processes (``_collective``); that
    # is ROADMAP.md Queue 1 item 15.

    def _bsi_dispatch(self, index: str, field_name: str, filter_call: Optional[Call],
                      shards, launch):
        """Lower the filter, then ``launch(prog, mats, mask, plane_mat,
        planes)`` under the stacks lock: (device result, canonical, depth,
        bsig), or None when the field is not an int field or the index has
        no shards.  A filter tree with no lowering, or past the kernels'
        limits, is UnsupportedLowering."""
        bsig = self._bsi_group(index, field_name)
        if bsig is None:
            return None
        depth = bsig.bit_depth()
        canonical = self.canonical_shards(index)
        with self._stacks_lock:
            view = view_bsi_name(field_name)
            stack = self._require_full_stack(index, field_name, view,
                                             self.field_stack(index, field_name, view, canonical))
            if stack is None:
                return None
            lw = _Lowering(self, canonical)
            if filter_call is not None:
                lw.row_hints = self._collect_row_hints(index, filter_call)
            prog = None if filter_call is None else self._lower(index, filter_call, lw)
            if prog is not None and not kernels.fits(prog):
                raise UnsupportedLowering("filter tree exceeds the kernels' limits")
            mask = self._mask_words(shards, canonical)
            planes = self._plane_spec(stack, depth)
            dev = self._reading(lw.stacks + [stack], lambda: launch(
                prog, lw.mats, mask, stack.matrix, planes))
        return dev, canonical, depth, bsig

    def sum_async(self, index: str, field_name: str, filter_call: Optional[Call], shards):
        """BSI Sum as one K6 launch, the result left on the device:
        (int64[depth + 1] counts, depth, bsig), or None (no int field)."""
        res = self._bsi_dispatch(index, field_name, filter_call, shards, bsi_mod.sum_tree)
        if res is None:
            return None
        dev, _, depth, bsig = res
        return dev, depth, bsig

    def sum(self, index: str, field_name: str, filter_call: Optional[Call], shards):
        """BSI Sum over the requested shards: (total, count), one launch and
        one readback; the weighted sum in Python ints."""
        res = self.sum_async(index, field_name, filter_call, shards)
        if res is None:
            return 0, 0
        dev, depth, bsig = res
        return bsi_mod.decode_sum(dev.cpu().numpy(), depth, bsig.min)

    def min_max_async(self, index: str, field_name: str, filter_call: Optional[Call],
                      shards, is_min: bool):
        """BSI Min or Max as one K7 launch, the per-shard (values, counts)
        left on the device: (result, canonical, depth, bsig), or None."""
        return self._bsi_dispatch(
            index, field_name, filter_call, shards,
            lambda *a: bsi_mod.minmax_tree(*a, is_min))

    def min_max(self, index: str, field_name: str, filter_call: Optional[Call], shards,
                is_min: bool):
        """BSI Min or Max: (value, count), or (0, 0) when no column was
        considered (fragment.go min/max :745-806 and ValCount's reduce)."""
        res = self.min_max_async(index, field_name, filter_call, shards, is_min)
        if res is None:
            return 0, 0
        (vals, counts), canonical, _, bsig = res
        host = torch.stack([vals, counts]).cpu().numpy()
        return bsi_mod.decode_min_max(host, canonical, bsig.min, is_min)

    # -- GroupBy (pilosa_tpu/parallel/engine.py:3702-3717, 4571-4673) ------

    def group_counts_async(self, index: str, fields: List[str], row_lists,
                           filter_call: Optional[Call], shards):
        """Fused GroupBy as one K8 launch, the int64[K_1 * ... * K_n] counts
        (row-major over ``row_lists``, the requested shards only) left on
        the device.  None when the fused path does not apply: no shards,
        or more than MAX_GROUP_COMBOS combinations or MAX_GROUP_FIELDS
        fields (counted in ``group_host_fallbacks``; the executor's host
        iterator serves them).  A listed row the stack lacks has no bits in
        the stack's snapshot and counts zero.  A filter with no device
        lowering, or past the kernels' limits, is UnsupportedLowering."""
        if not fields:
            raise ValueError("fused GroupBy requires at least one field")
        combos = 1
        for rows in row_lists:
            combos *= max(len(rows), 1)
        if combos > self.MAX_GROUP_COMBOS or len(fields) > groupby_mod.MAX_GROUP_FIELDS:
            self.group_host_fallbacks += 1
            return None
        canonical = self.canonical_shards(index)
        if not canonical:
            return None
        with self._stacks_lock:
            stacks = [self._require_full_stack(
                index, f, VIEW_STANDARD, self.field_stack(index, f, VIEW_STANDARD, canonical))
                for f in fields]
            idx_lists = [[st.row_index.get(r, -1) for r in rows]
                         for st, rows in zip(stacks, row_lists)]
            lw = _Lowering(self, canonical)
            if filter_call is not None:
                lw.row_hints = self._collect_row_hints(index, filter_call)
            prog = None if filter_call is None else self._lower(index, filter_call, lw)
            if prog is not None and not kernels.fits(prog):
                raise UnsupportedLowering("filter tree exceeds the kernels' limits")
            mask = self._mask_words(shards, canonical)
            self.group_dispatches += 1
            return self._reading(lw.stacks + stacks, lambda: groupby_mod.groupn_tree(
                prog, lw.mats, mask, [st.matrix for st in stacks], idx_lists))

    def group_counts(self, index: str, fields: List[str], row_lists,
                     filter_call: Optional[Call], shards):
        """Fused GroupBy: the counts as int64[K_1, ..., K_n] numpy, one
        launch and one readback, or None (see ``group_counts_async``)."""
        dev = self.group_counts_async(index, fields, row_lists, filter_call, shards)
        if dev is None:
            return None
        return dev.cpu().numpy().reshape(tuple(len(rows) for rows in row_lists))

    # -- whole-dashboard fusion (pilosa_tpu/parallel/engine.py:3390-3530) --
    #
    # The reference also keeps registry series of the counters (item 14)
    # and replays nothing across processes: a fused drain is single-process
    # there too.

    FUSED_PLAN_CACHE = 256

    def fused_many_async(self, index: str, entries):
        """``fused_drain_async`` over (spec, shards) pairs of one index."""
        return self.fused_drain_async([(index, spec, shards) for spec, shards in entries])

    def fused_drain_async(self, entries):
        """Plan and launch a heterogeneous drain, mixed Count/Sum/Min/Max/
        TopN/GroupBy items that may share Row subtrees and span indexes,
        without waiting for the device (``fusion.build`` / ``dispatch``).
        ``entries`` is a list of (index, spec, shards) triples, spec
        {"kind": ...} plus the op's arguments; returns a
        ``fusion.FusedDispatch`` whose decoders give each op's result."""
        entries = list(entries)
        n = len(entries)
        # Canonical order BEFORE keying and building: concurrent arrivals
        # of one dashboard interleave in any order, and an arrival-order
        # key would plan every permutation anew.  Entries with equal sort
        # keys are the same item, so the stable sort's remap is defined.
        try:
            keys = [fusion_mod._entry_sort_key(e) for e in entries]
            order = sorted(range(n), key=lambda i: keys[i])
        except Exception:  # noqa: BLE001 — an unkeyable spec: build as is
            keys, order = None, list(range(n))
        sorted_entries = [entries[i] for i in order]
        cache_key = None if keys is None else tuple(keys[i] for i in order)
        with self._stacks_lock:
            plan = self._fused_plan_for(sorted_entries, cache_key)
            fd = fusion_mod.dispatch(self, plan)
        if order == list(range(n)):
            return fd
        inv = [0] * n
        for at, i in enumerate(order):
            inv[i] = at
        return fusion_mod.FusedDispatch(
            fd.dev, fd.layout,
            [fd.decoders[inv[i]] for i in range(n)],
            [fd.weights[inv[i]] for i in range(n)],
            [fd.errors[inv[i]] for i in range(n)],
            [fd.item_notes[inv[i]] for i in range(n)],
        )

    def _fused_plan_for(self, entries, key):
        """A validated (possibly cached) ``fusion.FusedPlan`` for this exact
        (pre-sorted) drain shape.  Runs under the stacks lock."""
        if key is None:
            return fusion_mod.build(self, entries)
        plan = self._fused_plans.get(key)
        if plan is not None and self._fused_plan_valid(plan):
            self.fused_plan_hits += 1
            self._cache_hit("fused_plan")
            self._fused_plans.move_to_end(key)
            return plan
        self.fused_plan_misses += 1
        self._cache_miss("fused_plan")
        self._fused_plans.pop(key, None)
        plan = fusion_mod.build(self, entries)
        if plan.cacheable:
            self._fused_plans[key] = plan
            while len(self._fused_plans) > self.FUSED_PLAN_CACHE:
                self._fused_plans.popitem(last=False)
        return plan

    def _fused_plan_valid(self, plan) -> bool:
        """True when every reuse gate holds: each index's canonical shard
        axis, and every referenced stack present or absent as before with
        the same version token.  ``field_stack`` is consulted, not peeked,
        so a stale stack syncs FIRST: its token then moves (an in-place
        sync and a rebuild both change ``_FieldStack.versions``) and the
        plan rebuilds over the fresh stacks and occupancy."""
        for idx, canon in plan.canonical.items():
            if self.canonical_shards(idx) != canon:
                return False
        for (idx, field, view), (absent, tok) in plan.stack_tokens.items():
            st = self.field_stack(idx, field, view, plan.canonical.get(idx))
            if (st is None) != absent:
                return False
            if st is not None and st.versions != tok:
                return False
        return True

    def fused_many(self, index: str, entries):
        """Synchronous fused drain over (spec, shards) pairs of one index:
        launch and one readback, results in entry order."""
        return self.fused_drain([(index, spec, shards) for spec, shards in entries])

    def fused_drain(self, entries):
        """Synchronous cross-index drain over (index, spec, shards) triples:
        ``fused_drain_async``, one readback, each item's result (its error
        raised)."""
        try:
            fd = self.fused_drain_async(entries)
        finally:
            # The async form leaves its note for its dispatcher (the batcher);
            # here the caller records no plan, so claim it.
            plans_mod.take_dispatch_note()
        return fd.results(fd.dev.cpu().numpy())

    # -- the aggregate lane's per-op programs and memo -----------------------

    def solo_op_async(self, index: str, kind: str, spec: dict, shards):
        """One item on its own per-op program (K1/K2, K6, K7, K3 or K8),
        without waiting for the device: (device tensors, decoder over their
        host arrays), or (None, decoder of a constant) when no launch is
        needed.  The decoders are fusion.py's, so the results match the
        synchronous wrappers."""
        if kind == "count":
            return [self.count_async(index, spec["call"], shards)], fusion_mod._ScalarDecode()
        if kind == "sum":
            res = self.sum_async(index, spec["field"], spec.get("filter"), shards)
            if res is None:
                return None, fusion_mod._Const((0, 0))
            dev, depth, bsig = res
            return [dev], fusion_mod._SumDecode(depth, bsig.min)
        if kind in ("min", "max"):
            res = self.min_max_async(index, spec["field"], spec.get("filter"), shards,
                                     kind == "min")
            if res is None:
                return None, fusion_mod._Const((0, 0))
            (vals, counts), canonical, _, bsig = res
            return [vals, counts], fusion_mod._MinMaxDecode(list(canonical), bsig.min,
                                                            kind == "min")
        if kind == "topn":
            res = self.topn_scores_async(index, spec["field"], spec["rows"], spec["src"],
                                         shards)
            return (None, fusion_mod._Const(None)) if res is None else res
        if kind == "topnf":
            res = self.topn_full_async(index, spec["field"], spec["src"], shards,
                                       spec.get("n") or 0, spec.get("threshold") or 1,
                                       spec.get("row_ids"))
            if res is None:
                return None, fusion_mod._Const(fusion_mod.DECLINED)
            cands, n_out, out = res
            if out is None:
                return None, fusion_mod._Const([])
            return [out], fusion_mod._TopNDeviceDecode(cands, n_out)
        if kind == "group":
            dev = self.group_counts_async(index, spec["fields"], spec["rows"],
                                          spec.get("filter"), shards)
            if dev is None:
                return None, fusion_mod._Const(fusion_mod.DECLINED)
            return [dev], fusion_mod._GroupDecode(tuple(len(r) for r in spec["rows"]))
        raise ValueError(f"unknown solo op kind: {kind!r}")

    def solo_op(self, index: str, kind: str, spec: dict, shards):
        """Blocking single-op dispatch (the batcher's idle direct path):
        the op's result, DECLINED where its fused lane would decline."""
        tensors, dec = self.solo_op_async(index, kind, spec, shards)
        if tensors is None:
            return dec(None)
        return dec([t.cpu().numpy() for t in tensors])

    def probe_fused_item(self, index: str, spec: dict, shards):
        """Host-only lowering probe for batch-failure attribution: lower the
        item's mask tree without launching; raises the item's own error."""
        kind = spec["kind"]
        if kind == "count":
            trees = [spec["call"]]
        elif kind in ("sum", "min", "max", "group"):
            trees = [spec["filter"]] if spec.get("filter") is not None else []
        else:
            trees = [spec["src"]]
        lw = _Lowering(self, self.canonical_shards(index))
        lw.row_hints = fusion_mod._item_hints(self, index, spec)
        for t in trees:
            prog = self._lower(index, t, lw)
            if not kernels.fits(prog):
                raise UnsupportedLowering("tree exceeds the kernels' limits")

    # The op kinds whose results ride the result memo (the reference's
    # _OP_CACHE_TAG); TopN scores and GroupBy do not (the executor keeps
    # GroupBy's shaped counts itself, memo_probe_groupby).
    _MEMO_OPS = frozenset(("sum", "min", "max", "topnf"))
    # Each memoized op's cache name in cache_stats.
    _OP_CACHE_TAG = {"sum": "memo_sum", "min": "memo_min", "max": "memo_max",
                     "topnf": "memo_topn"}
    # The repair-layer kind of each memoized op (the full TopN has none).
    _REPAIR_KIND = {"sum": "sum", "min": "minmax", "max": "minmax"}

    def memo_key_op(self, index: str, kind: str, spec: dict, shards):
        """Memo key of an aggregate op: ``_memo_key``'s shape, signed by the
        op's canonical spec text (``fusion.op_signature``)."""
        if self.result_memo.maxsize <= 0:
            return None
        fields = fusion_mod.op_fields(kind, spec, self._collect_fields)
        if fields is None:
            return None
        toks = self.memo_tokens(index, fields)
        if toks is None:
            return None
        return (index, "op:" + fusion_mod.op_signature(kind, spec),
                tuple(sorted(set(shards))), toks)

    def memo_probe_op(self, index: str, kind: str, spec: dict, shards):
        """(key, value-or-None) for ``submit_op``: a hit answers the op with
        no launch.  A miss probes the repair layer (Sum from plane-popcount
        deltas; Min/Max from the per-field extremum table)."""
        if kind not in self._MEMO_OPS:
            return None, None
        key = self.memo_key_op(index, kind, spec, shards)
        if key is None:
            return None, None
        v = self._memo_get(self._REPAIR_KIND.get(kind), key, self._OP_CACHE_TAG[kind])
        if v is not None and kind == "topnf":
            v = [tuple(p) for p in v]
        return key, v

    def memo_store_op(self, key, kind: str, spec: dict, value):
        """Store an op's result under its submit-time key; Sum and Min/Max
        also register their plane footprints for repair.  DECLINED is never
        stored."""
        if key is None or value is None or value is fusion_mod.DECLINED:
            return
        if kind == "topnf":
            self.result_memo.put(key, tuple(map(tuple, value)))
            return
        self.result_memo.put(key, value)
        if kind == "sum":
            self.repairs.register_sum(key, spec["field"], spec.get("filter"), value)
        elif kind in ("min", "max"):
            self.repairs.register_minmax(key, spec["field"], spec.get("filter"),
                                         kind == "min", value)

    # -- the aggregate lane (pilosa_tpu/parallel/engine.py:3652-3720) --------

    def batched_sum(self, index: str, field: str, filter_call, shards):
        """BSI Sum through the batcher: a lone caller runs K6 directly;
        concurrent callers drain into one fused program with their
        drain-mates."""
        return self.batcher().submit_op(
            index, "sum", {"kind": "sum", "field": field, "filter": filter_call}, shards)

    def batched_min_max(self, index: str, field: str, filter_call, shards, is_min: bool):
        kind = "min" if is_min else "max"
        return self.batcher().submit_op(
            index, kind, {"kind": kind, "field": field, "filter": filter_call}, shards)

    def batched_topn_scores(self, index: str, field: str, candidate_rows, src_call, shards):
        return self.batcher().submit_op(
            index, "topn", {"kind": "topn", "field": field, "rows": list(candidate_rows),
                            "src": src_call}, shards)

    def batched_topn_full(self, index: str, field: str, src_call, shards, n: int,
                          min_threshold: int, row_ids=None):
        """Full TopN through the batcher: sorted pairs, or None when the
        fused path declines (candidate union too large)."""
        out = self.batcher().submit_op(
            index, "topnf",
            {"kind": "topnf", "field": field, "src": src_call, "n": int(n),
             "threshold": int(min_threshold),
             "row_ids": None if not row_ids else list(row_ids)},
            shards)
        return None if out is fusion_mod.DECLINED else out

    def batched_group_counts(self, index: str, fields: List[str], row_lists,
                             filter_call: Optional[Call], shards):
        """GroupBy through the batcher: the counts int64[K_1, ..., K_n], or
        None when the fused path declines (past MAX_GROUP_COMBOS
        combinations, or a missing stack): the executor's host iterator
        then serves it."""
        out = self.batcher().submit_op(
            index, "group",
            {"kind": "group", "fields": list(fields), "rows": [list(r) for r in row_lists],
             "filter": filter_call},
            shards)
        return None if out is fusion_mod.DECLINED else out

    # -- residency telemetry (pilosa_tpu/parallel/engine.py:4745-4880) -------

    def resident_block_fraction(self) -> float:
        """Occupied blocks resident on the card over the occupied blocks of
        the known stacks' full row universes (1.0 with no stack)."""
        res = tot = 0
        with self._stacks_lock:
            for st in self._stacks.values():
                rb = bitops.popcount_np(st.occ)
                tb = st.universe_blocks if st.partial and st.universe_blocks is not None else rb
                res += rb
                tot += max(tb, rb)  # writes may grow occ past the promotion's count
        return round(res / tot, 4) if tot else 1.0

    def refresh_metrics(self):
        """Scrape-time gauges of the residency state."""
        REGISTRY.set_gauge(METRIC_ENGINE_RESIDENT_BLOCK_FRACTION, self.resident_block_fraction())

    def _working_set_snapshot(self) -> dict:
        """Per-index resident-vs-total bytes, the promotion queue and the
        eviction pressure (/debug/vars ``engineCaches.workingSet``)."""
        per: Dict[str, dict] = {}
        with self._stacks_lock:
            for (idx, _f, _v), st in self._stacks.items():
                d = per.setdefault(idx, {"stacks": 0, "partialStacks": 0,
                                         "residentBytes": 0, "totalBytes": 0})
                d["stacks"] += 1
                d["partialStacks"] += int(st.partial)
                d["residentBytes"] += int(st.footprint)
                d["totalBytes"] += int(st.universe_rows) * len(st.shards) * ROW_SHARD_BYTES
        for d in per.values():
            d["residentFraction"] = (round(min(1.0, d["residentBytes"] / d["totalBytes"]), 4)
                                     if d["totalBytes"] else 1.0)
        res = self.residency.snapshot()
        return {
            "perIndex": per,
            "pendingPromotions": res["pendingPromotions"],
            "inflightBytes": res["inflightBytes"],
            "evictionPressure": {"evictions": self.evictions,
                                 "budgetEvictions": self.budget_evictions,
                                 "promotionsDeclined": res["declined"],
                                 "hostFallbacks": self.host_fallbacks},
            "deviceBudgetBytes": self.max_resident_bytes,
        }

    def cache_snapshot(self) -> dict:
        """Cache telemetry for /debug/vars: per-cache hit/miss tallies (the
        counts the pilosa_engine_cache_* series export), the stack cache
        (resident and evicted-live bytes, evictions, rebuilds and syncs,
        the residency fraction, the promotion worker's snapshot, the
        working set) and the sparsity counters."""
        self.refresh_metrics()
        with self._stacks_lock:
            resident = self._resident_bytes
            pending = self._pending_bytes()
            n_stacks = len(self._stacks)
            partial = sum(1 for st in self._stacks.values() if st.partial)
        return {
            "caches": {name: {"hits": hm[0], "misses": hm[1]}
                       for name, hm in self.cache_stats.items()},
            "residentBytes": resident,
            "evictedLiveBytes": pending,
            "deviceBudgetBytes": self.max_resident_bytes,
            "evictions": self.evictions,
            "budgetEvictions": self.budget_evictions,
            "stackRebuilds": self.stack_rebuilds,
            "stackUpdates": self.stack_updates,
            "stacks": n_stacks,
            "partialStacks": partial,
            "residentBlockFraction": self.resident_block_fraction(),
            "hostFallbacks": self.host_fallbacks,
            "lastPromoteError": self.last_promote_error,
            "residency": self.residency.snapshot(),
            "workingSet": self._working_set_snapshot(),
            "resultMemoEntries": len(self.result_memo._od),
            "resultRepair": self.repairs.snapshot(),
            "fusedPlans": len(self._fused_plans),
            "sparseDispatches": self.sparse_dispatches,
            "deviceBytesSkipped": self.device_bytes_skipped,
        }
