// Native sparse-merge kernels: the host-side hot path for id-pairs ingest.
//
// C++ twin of RowStore._merge_sparse / the dense branch of
// RowStore.bulk_merge (core/rowstore.py).  The numpy path costs ~10
// full-array passes per batch (repeat/concat key build, searchsorted, hit
// masks, shifted-offset merge, re-split); these kernels do the whole
// union/difference + per-row re-split in ONE linear pass, consuming the
// store's per-row sorted position arrays through a pointer table so the
// existing side is never materialized into packed keys at all.  The numpy
// implementation is retained verbatim as the automatic fallback and the
// differential oracle (tests/test_torch_native.py).
//
// C ABI, caller-allocated outputs: every capacity is a closed-form bound
// (union <= na+nb, difference <= na), so there is no two-pass sizing.
// Returns the output row count, or a negative error code.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int64_t kErrBadArgs = -1;

// Streaming writer for (merged positions, per-row split).  Keys arrive in
// ascending packed (row << exp | pos) order; the writer peels the row id
// and opens a new row group whenever it changes.
struct RowSplitWriter {
  uint32_t* pos_out;
  int64_t* rows_out;
  int64_t* bounds_out;
  int32_t exp;
  uint32_t mask;
  int64_t n = 0;       // positions written
  int64_t n_rows = 0;  // row groups opened
  int64_t cur_row = -1;

  inline void emit(int64_t key) {
    int64_t r = key >> exp;
    if (r != cur_row) {
      rows_out[n_rows] = r;
      bounds_out[n_rows] = n;
      n_rows++;
      cur_row = r;
    }
    pos_out[n++] = static_cast<uint32_t>(key) & mask;
  }

  inline int64_t finish(int64_t* n_merged) {
    bounds_out[n_rows] = n;
    if (n_merged) *n_merged = n;
    return n_rows;
  }
};

// Cursor over the existing side: per-row sorted uint32 position arrays
// (rows ascending, positions ascending within each row), yielded as
// packed keys without materializing them.
struct GatherCursor {
  const int64_t* rows;
  const uint32_t* const* ptrs;
  const int64_t* lens;
  int64_t n_rows;
  int32_t exp;
  int64_t ri = 0, k = 0;

  inline bool done() const { return ri >= n_rows; }
  inline int64_t key() const {
    return (rows[ri] << exp) | static_cast<int64_t>(ptrs[ri][k]);
  }
  inline void advance() {
    if (++k >= lens[ri]) {
      k = 0;
      do {
        ri++;
      } while (ri < n_rows && lens[ri] == 0);
    }
  }
  inline void init() {
    while (ri < n_rows && lens[ri] == 0) ri++;
  }
};

}  // namespace

extern "C" {

int32_t sm_abi_version() { return 1; }

// Sorted-merge UNION of the existing per-row arrays with a sorted unique
// int64 packed batch ``b``; writes merged in-row positions (capacity
// sum(lens)+nb), the distinct output row ids, and their bounds (capacity
// n_out_rows+1 — sum of both sides' distinct rows is a safe bound).
// Returns the output row count; *n_merged receives the position count.
int64_t sm_union_split(const int64_t* a_rows, const uint32_t* const* a_ptrs,
                       const int64_t* a_lens, int64_t a_nrows,
                       const int64_t* b, int64_t nb, int32_t exp,
                       uint32_t mask, uint32_t* pos_out, int64_t* rows_out,
                       int64_t* bounds_out, int64_t* n_merged) {
  if (exp <= 0 || exp >= 63) return kErrBadArgs;
  GatherCursor a{a_rows, a_ptrs, a_lens, a_nrows, exp};
  a.init();
  RowSplitWriter w{pos_out, rows_out, bounds_out, exp, mask};
  int64_t j = 0;
  while (!a.done() && j < nb) {
    int64_t ak = a.key(), bk = b[j];
    if (ak < bk) {
      w.emit(ak);
      a.advance();
    } else if (bk < ak) {
      w.emit(bk);
      j++;
    } else {
      w.emit(ak);
      a.advance();
      j++;
    }
  }
  while (!a.done()) {
    w.emit(a.key());
    a.advance();
  }
  for (; j < nb; j++) w.emit(b[j]);
  return w.finish(n_merged);
}

// Sorted-merge DIFFERENCE: existing minus batch.  Rows emptied entirely
// produce no output group (the caller zeroes them).  Output capacities:
// positions sum(lens), rows/bounds a_nrows (+1).
int64_t sm_diff_split(const int64_t* a_rows, const uint32_t* const* a_ptrs,
                      const int64_t* a_lens, int64_t a_nrows,
                      const int64_t* b, int64_t nb, int32_t exp,
                      uint32_t mask, uint32_t* pos_out, int64_t* rows_out,
                      int64_t* bounds_out, int64_t* n_merged) {
  if (exp <= 0 || exp >= 63) return kErrBadArgs;
  GatherCursor a{a_rows, a_ptrs, a_lens, a_nrows, exp};
  a.init();
  RowSplitWriter w{pos_out, rows_out, bounds_out, exp, mask};
  int64_t j = 0;
  while (!a.done()) {
    int64_t ak = a.key();
    while (j < nb && b[j] < ak) j++;
    if (j < nb && b[j] == ak) {
      j++;  // dropped
    } else {
      w.emit(ak);
    }
    a.advance();
  }
  return w.finish(n_merged);
}

// Set (clear=0) or clear (clear=1) bits at sorted unique in-row positions
// in a dense uint64 word vector; popcounts ONLY the touched words.
// Returns the signed cardinality delta (after - before); INT64_MIN on an
// out-of-range position (a plain negative value is a legitimate delta).
int64_t sm_apply_dense(uint64_t* words, int64_t n_words, const uint32_t* pos,
                       int64_t n, int32_t clear) {
  constexpr int64_t kErrRange = INT64_MIN;
  int64_t delta = 0;
  int64_t i = 0;
  while (i < n) {
    int64_t wi = pos[i] >> 6;
    if (wi >= n_words) return kErrRange;
    uint64_t m = 0;
    do {
      m |= 1ULL << (pos[i] & 63);
      i++;
    } while (i < n && (pos[i] >> 6) == wi);
    uint64_t before = words[wi];
    uint64_t after = clear ? (before & ~m) : (before | m);
    words[wi] = after;
    delta += __builtin_popcountll(after) - __builtin_popcountll(before);
  }
  return delta;
}

// Stable counting-sort partition of parallel int64 (cols, rows) arrays by
// shard (col >> exp): linear passes replace the O(n log n) argsort that
// dominated the import front end.  Compact shard ranges (span <=
// max_shards — the common ingest shape) use a direct-index count table,
// O(1) per element; wide keyspaces whose span overflows the table but
// that still touch few DISTINCT shards discover them into a small sorted
// table (binary search per element).  Outputs: cols/rows regrouped
// shard-major with original order preserved within each shard, the
// ascending shard ids, and their bounds (capacity max_shards /
// max_shards+1).  Returns the shard count, or -1 only when more than
// max_shards DISTINCT shards appear (callers fall back to the argsort
// path).
int64_t sm_shard_split(const int64_t* cols, const int64_t* rows, int64_t n,
                       int32_t exp, int64_t max_shards, int64_t* cols_out,
                       int64_t* rows_out, int64_t* shard_ids_out,
                       int64_t* bounds_out) {
  if (exp <= 0 || exp >= 63) return kErrBadArgs;
  if (n <= 0) return 0;
  int64_t lo = cols[0] >> exp, hi = lo;
  for (int64_t i = 1; i < n; i++) {
    int64_t s = cols[i] >> exp;
    if (s < lo) lo = s;
    if (s > hi) hi = s;
  }
  int64_t span = hi - lo + 1;
  if (span > 0 && span <= max_shards) {
    // Dense span: direct-index count table, O(1) per element.
    std::vector<int64_t> counts(span, 0);
    for (int64_t i = 0; i < n; i++) counts[(cols[i] >> exp) - lo]++;
    std::vector<int64_t> cursor(span);
    int64_t n_shards = 0, off = 0;
    for (int64_t k = 0; k < span; k++) {
      cursor[k] = off;
      if (counts[k]) {
        shard_ids_out[n_shards] = lo + k;
        bounds_out[n_shards] = off;
        n_shards++;
        off += counts[k];
      }
    }
    bounds_out[n_shards] = off;
    for (int64_t i = 0; i < n; i++) {
      int64_t at = cursor[(cols[i] >> exp) - lo]++;
      cols_out[at] = cols[i];
      rows_out[at] = rows[i];
    }
    return n_shards;
  }
  // Sparse span (cols far apart — e.g. two shards 100k ids apart, or a
  // span that overflowed int64): sorted distinct-shard table, binary
  // search per element.
  std::vector<int64_t> table, counts;
  table.reserve(64);
  counts.reserve(64);
  for (int64_t i = 0; i < n; i++) {
    int64_t s = cols[i] >> exp;
    auto it = std::lower_bound(table.begin(), table.end(), s);
    size_t k = it - table.begin();
    if (it == table.end() || *it != s) {
      if (static_cast<int64_t>(table.size()) >= max_shards)
        return kErrBadArgs;
      table.insert(it, s);
      counts.insert(counts.begin() + k, 0);
    }
    counts[k]++;
  }
  int64_t n_shards = static_cast<int64_t>(table.size()), off = 0;
  std::vector<int64_t> cursor(n_shards);
  for (int64_t k = 0; k < n_shards; k++) {
    shard_ids_out[k] = table[k];
    bounds_out[k] = off;
    cursor[k] = off;
    off += counts[k];
  }
  bounds_out[n_shards] = off;
  for (int64_t i = 0; i < n; i++) {
    int64_t s = cols[i] >> exp;
    size_t k =
        std::lower_bound(table.begin(), table.end(), s) - table.begin();
    int64_t at = cursor[k]++;
    cols_out[at] = cols[i];
    rows_out[at] = rows[i];
  }
  return n_shards;
}

}  // extern "C"
