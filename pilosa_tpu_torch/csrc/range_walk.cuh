// The body of a BSI range condition's bit-plane walk (pilosa_tpu/ops/bsi.py,
// fragment.go rangeEQ/NEQ/LT/GT/Between), high bit first, for U positions.
// Not a header of its own: it is included inside a function body whose
// scope holds `r` (kind, depth, lo, hi), `out` (uint4[U]) and the template
// parameter U, with RANGE_PLANE(i, u) defined as plane i at position u.
// tree_eval.cuh's eval_range reads the planes from device memory; K5's
// range_walk (count_batch_tree.cu) from its staged tile.  One text, not a
// template over a loader: eval_range is inlined into K1, K2, K3, K6, K7, K8
// and F1, and routing it through a loader moved their SASS, where the same
// tokens as before leave it alone.
  const int depth = r.depth;
  const int kind = r.kind;
  uint4 b[U], k1[U], k2[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    b[u] = RANGE_PLANE(depth, u);
    k1[u] = k2[u] = make_uint4(0u, 0u, 0u, 0u);
  }
  const bool eq = kind == RANGE_EQ || kind == RANGE_NEQ;
  const bool lt = kind == RANGE_LT || kind == RANGE_LTE;
  const bool gt = kind == RANGE_GT || kind == RANGE_GTE;
  const bool allow_eq = kind == RANGE_LTE || kind == RANGE_GTE;
  bool lz = true;  // lt: still in the predicate's leading zeros
  for (int i = depth - 1; i >= 0; --i) {
    const bool bit = (r.lo >> i) & 1ull;
    const bool bit2 = (r.hi >> i) & 1ull;
    uint4 row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) row[u] = RANGE_PLANE(i, u);
    if (eq) {
#pragma unroll
      for (int u = 0; u < U; ++u) b[u] = bit ? and4(b[u], row[u]) : andn4(b[u], row[u]);
    } else if (lt) {
      if (i == 0 && !allow_eq) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          out[u] = bit ? andn4(b[u], andn4(row[u], k1[u])) : k1[u];
        return;
      }
      if (!bit) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          b[u] = lz ? andn4(b[u], row[u]) : andn4(b[u], andn4(row[u], k1[u]));
      } else if (i > 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) k1[u] = or4(k1[u], andn4(b[u], row[u]));
      }
      lz = lz && !bit;
    } else if (gt) {
      if (i == 0 && !allow_eq) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          out[u] = bit ? k1[u] : andn4(b[u], andn4(andn4(b[u], row[u]), k1[u]));
        return;
      }
      if (bit) {
#pragma unroll
        for (int u = 0; u < U; ++u) b[u] = andn4(b[u], andn4(andn4(b[u], row[u]), k1[u]));
      } else if (i > 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) k1[u] = or4(k1[u], and4(b[u], row[u]));
      }
    } else {  // RANGE_BETWEEN: the >= lo and <= hi walks fused
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (bit) b[u] = andn4(b[u], andn4(andn4(b[u], row[u]), k1[u]));
        else if (i > 0) k1[u] = or4(k1[u], and4(b[u], row[u]));
        if (!bit2) b[u] = andn4(b[u], andn4(row[u], k2[u]));
        else if (i > 0) k2[u] = or4(k2[u], andn4(b[u], row[u]));
      }
    }
  }
  if (kind == RANGE_NEQ) {
#pragma unroll
    for (int u = 0; u < U; ++u) b[u] = andn4(RANGE_PLANE(depth, u), b[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) out[u] = b[u];
