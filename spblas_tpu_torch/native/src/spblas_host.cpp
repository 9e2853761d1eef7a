// spblas_host — native host-side inspector runtime for spblas_tpu.
//
// TPU-native division of labor: device numerics live in XLA/Pallas; the
// *inspector* phases (plan construction, dependency analysis, format IO)
// are host-side pointer-chasing workloads that the reference implements in
// C++ (header-only algorithms, include/spblas/algorithms/*_impl.hpp) and
// vendors hide inside handle "optimize" calls.  These are the equivalent
// native components, exported with a plain C ABI and bound via ctypes
// (no pybind11 in this toolchain).
//
// Everything is int64/float64-free on the wire where possible: indices are
// int32 (vendor precedent: reference vendor/rocsparse/types.hpp:11-12),
// offsets int64 for safety in intermediate sums.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ----------------------------------------------------------------- //
// ELL plan geometry (inspect step of the optimized SpMV/SpMM path).
// Writes (m_pad, w) arrays: values gather index, column id, valid flag.
// Returns the chosen width w (>=1).  rowptr is int64[m+1] clamped to nnz.
// ----------------------------------------------------------------- //
int64_t spblas_ell_build(int64_t m, int64_t m_pad, int64_t nnz,
                         const int64_t* rowptr, const int32_t* colind,
                         int64_t w,            // 0 → derive max row length
                         int32_t* out_gather,  // (m_pad * w)
                         int32_t* out_cols,    // (m_pad * w)
                         uint8_t* out_valid) { // (m_pad * w)
  if (w == 0) {
    for (int64_t i = 0; i < m; ++i) {
      int64_t lo = std::min(rowptr[i], nnz), hi = std::min(rowptr[i + 1], nnz);
      w = std::max(w, hi - lo);
    }
    if (w == 0) w = 1;
    return w;  // first call: geometry query only
  }
  std::memset(out_gather, 0, sizeof(int32_t) * m_pad * w);
  std::memset(out_cols, 0, sizeof(int32_t) * m_pad * w);
  std::memset(out_valid, 0, sizeof(uint8_t) * m_pad * w);
  for (int64_t i = 0; i < m; ++i) {
    int64_t lo = std::min(rowptr[i], nnz), hi = std::min(rowptr[i + 1], nnz);
    int64_t len = std::min(hi - lo, w);
    int32_t* g = out_gather + i * w;
    int32_t* c = out_cols + i * w;
    uint8_t* v = out_valid + i * w;
    for (int64_t j = 0; j < len; ++j) {
      g[j] = static_cast<int32_t>(lo + j);
      c[j] = colind[lo + j];
      v[j] = 1;
    }
  }
  return w;
}

// ----------------------------------------------------------------- //
// Level-set analysis for SpTRSV (the work vendors bury in
// optimize_trsv).  Computes level of every row of a triangular matrix:
// level(i) = 1 + max level over off-diagonal deps.  Returns the number
// of levels; out_levels is int32[m]; out_diag is int64[m] (entry index
// of the diagonal, -1 if absent).  lower != 0 → lower triangle.
// Returns -1 if an explicit-diagonal solve would divide by a missing
// diagonal (caller passes unit != 0 to skip that check).
// ----------------------------------------------------------------- //
int64_t spblas_level_schedule(int64_t m, int64_t nnz, const int64_t* rowptr,
                              const int32_t* colind, int32_t lower,
                              int32_t unit, int32_t* out_levels,
                              int64_t* out_diag) {
  int64_t num_levels = 0;
  int64_t i0 = lower ? 0 : m - 1;
  int64_t step = lower ? 1 : -1;
  for (int64_t t = 0; t < m; ++t) {
    int64_t i = i0 + step * t;
    int64_t lo = std::min(rowptr[i], nnz), hi = std::min(rowptr[i + 1], nnz);
    int32_t lev = 0;
    int64_t diag = -1;
    for (int64_t e = lo; e < hi; ++e) {
      int32_t j = colind[e];
      if (j == i) {
        // unit-diagonal semantics: diagonal entries are NOT read
        // (triangular_types.hpp) — leave diag = -1 so solvers use 1
        if (!unit) diag = e;
      } else if ((lower && j < i) || (!lower && j > i)) {
        lev = std::max(lev, out_levels[j] + 1);
      }
    }
    if (diag < 0 && !unit) return -1;
    out_levels[i] = lev;
    out_diag[i] = diag;
    num_levels = std::max<int64_t>(num_levels, lev + 1);
  }
  return m == 0 ? 0 : num_levels;
}

// ----------------------------------------------------------------- //
// CSR transpose structure (counting sort) — host mirror of the two-pass
// algorithm (reference algorithms/transpose_impl.hpp:16-53), used by
// converters and IO.  out_rowptr int64[n+1], out_perm int64[nnz]: entry
// e of the transpose gathers source entry out_perm[e].
// ----------------------------------------------------------------- //
void spblas_transpose_plan(int64_t m, int64_t n, int64_t nnz,
                           const int64_t* rowptr, const int32_t* colind,
                           int64_t* out_rowptr, int64_t* out_perm,
                           int32_t* out_colind) {
  std::memset(out_rowptr, 0, sizeof(int64_t) * (n + 1));
  for (int64_t e = 0; e < nnz; ++e) out_rowptr[colind[e] + 1]++;
  for (int64_t j = 0; j < n; ++j) out_rowptr[j + 1] += out_rowptr[j];
  std::vector<int64_t> cursor(out_rowptr, out_rowptr + n);
  for (int64_t i = 0; i < m; ++i) {
    int64_t lo = std::min(rowptr[i], nnz), hi = std::min(rowptr[i + 1], nnz);
    for (int64_t e = lo; e < hi; ++e) {
      int64_t slot = cursor[colind[e]]++;
      out_perm[slot] = e;
      out_colind[slot] = static_cast<int32_t>(i);
    }
  }
}

// ----------------------------------------------------------------- //
// Gustavson symbolic SpGEMM on host (dense SPA-set per row) — the
// planning pass behind the distributed SpGEMM inspector.  Returns total
// nnz of C; fills out_rowptr int64[m+1].  Mirrors the reference's
// symbolic phase (spgemm_gustavsons.hpp:60-89) with a versioned SPA so
// clearing is O(1) per row.
// ----------------------------------------------------------------- //
int64_t spblas_spgemm_symbolic(int64_t m, int64_t n, int64_t nnz_a,
                               int64_t nnz_b, const int64_t* a_rowptr,
                               const int32_t* a_colind,
                               const int64_t* b_rowptr,
                               const int32_t* b_colind,
                               int64_t* out_rowptr) {
  std::vector<int64_t> mark(n, -1);
  out_rowptr[0] = 0;
  int64_t total = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t lo = std::min(a_rowptr[i], nnz_a);
    int64_t hi = std::min(a_rowptr[i + 1], nnz_a);
    int64_t count = 0;
    for (int64_t e = lo; e < hi; ++e) {
      int32_t k = a_colind[e];
      int64_t blo = std::min(b_rowptr[k], nnz_b);
      int64_t bhi = std::min(b_rowptr[k + 1], nnz_b);
      for (int64_t f = blo; f < bhi; ++f) {
        int32_t j = b_colind[f];
        if (mark[j] != i) {
          mark[j] = i;
          ++count;
        }
      }
    }
    total += count;
    out_rowptr[i + 1] = total;
  }
  return total;
}

// ----------------------------------------------------------------- //
// Matrix Market (coordinate, real/integer/pattern) reader: two-call
// protocol.  Call 1 (buffers null): parse header, return nnz and write
// shape into out_shape[0..1]; general/symmetric expansion accounted.
// Call 2: fill COO arrays (0-based, duplicates preserved, symmetric
// entries expanded).  Returns -errno-style negative codes on failure.
// ----------------------------------------------------------------- //
int64_t spblas_mm_read(const char* path, int64_t capacity,
                       int64_t* out_shape,
                       int32_t* out_rows, int32_t* out_cols,
                       double* out_vals) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[1024];
  if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -2; }
  // the MM spec makes the banner case-insensitive ("%%MatrixMarket
  // matrix coordinate Real General" is valid) — lowercase before the
  // keyword checks
  for (char* p = line; *p; ++p)
    *p = (char)std::tolower((unsigned char)*p);
  bool pattern = std::strstr(line, "pattern") != nullptr;
  bool symmetric = std::strstr(line, "symmetric") != nullptr ||
                   std::strstr(line, "skew-symmetric") != nullptr ||
                   std::strstr(line, "hermitian") != nullptr;
  bool skew = std::strstr(line, "skew-symmetric") != nullptr;
  if (!std::strstr(line, "matrix") || !std::strstr(line, "coordinate")) {
    std::fclose(f);
    return -3;  // dense/array format not handled here
  }
  if (std::strstr(line, "complex")) {
    std::fclose(f);
    return -6;  // complex values unsupported by this reader
  }
  // skip comments
  long header_pos;
  do {
    header_pos = std::ftell(f);
    if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -2; }
  } while (line[0] == '%');
  int64_t m, n, nz;
  if (std::sscanf(line, "%ld %ld %ld", &m, &n, &nz) != 3) {
    std::fclose(f);
    return -4;
  }
  if (out_rows == nullptr) {  // header-only call: count expanded entries
    int64_t total = 0;
    for (int64_t e = 0; e < nz; ++e) {
      long i, j;
      double v = 1.0;
      if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -5; }
      int got = pattern ? std::sscanf(line, "%ld %ld", &i, &j)
                        : std::sscanf(line, "%ld %ld %lf", &i, &j, &v);
      if (got < 2) { std::fclose(f); return -5; }
      total += (symmetric && i != j) ? 2 : 1;
    }
    out_shape[0] = m;
    out_shape[1] = n;
    std::fclose(f);
    return total;
  }
  int64_t w = 0;
  for (int64_t e = 0; e < nz; ++e) {
    long i, j;
    double v = 1.0;
    if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -5; }
    int got = pattern ? std::sscanf(line, "%ld %ld", &i, &j)
                      : std::sscanf(line, "%ld %ld %lf", &i, &j, &v);
    if (got < 2) { std::fclose(f); return -5; }
    // the fill pass re-parses the file: bound writes by the capacity
    // the caller allocated from the count pass (a file that changed
    // between the calls must fail, not overrun the buffers)
    if (w + ((symmetric && i != j) ? 2 : 1) > capacity) {
      std::fclose(f);
      return -7;
    }
    out_rows[w] = static_cast<int32_t>(i - 1);
    out_cols[w] = static_cast<int32_t>(j - 1);
    out_vals[w] = v;
    ++w;
    if (symmetric && i != j) {
      out_rows[w] = static_cast<int32_t>(j - 1);
      out_cols[w] = static_cast<int32_t>(i - 1);
      out_vals[w] = skew ? -v : v;
      ++w;
    }
  }
  std::fclose(f);
  return w;
}

// ----------------------------------------------------------------- //
// COO → CSR build (sort by row, col) for the IO path.
// rows/cols int32[nnz], vals double[nnz] permuted in place via an index
// sort; out_rowptr int64[m+1].
// ----------------------------------------------------------------- //
void spblas_coo_to_csr(int64_t m, int64_t nnz, int32_t* rows, int32_t* cols,
                       double* vals, int64_t* out_rowptr) {
  std::vector<int64_t> idx(nnz);
  for (int64_t e = 0; e < nnz; ++e) idx[e] = e;
  std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });
  std::vector<int32_t> r2(nnz), c2(nnz);
  std::vector<double> v2(nnz);
  for (int64_t e = 0; e < nnz; ++e) {
    r2[e] = rows[idx[e]];
    c2[e] = cols[idx[e]];
    v2[e] = vals[idx[e]];
  }
  std::memcpy(rows, r2.data(), sizeof(int32_t) * nnz);
  std::memcpy(cols, c2.data(), sizeof(int32_t) * nnz);
  std::memcpy(vals, v2.data(), sizeof(double) * nnz);
  std::memset(out_rowptr, 0, sizeof(int64_t) * (m + 1));
  for (int64_t e = 0; e < nnz; ++e) out_rowptr[rows[e] + 1]++;
  for (int64_t i = 0; i < m; ++i) out_rowptr[i + 1] += out_rowptr[i];
}

}  // extern "C"

// ----------------------------------------------------------------- //
// Reverse Cuthill-McKee bandwidth reduction on the symmetrized graph
// A + A^T.  The inspector step of the permuted-band plan: on TPUs,
// per-element gather is catastrophically slow, so generic sparsity is
// restructured into dense band panels when a low-bandwidth ordering
// exists.  out_perm int64[m]: new-order -> old row id.  Returns the
// half bandwidth of the permuted matrix.
// ----------------------------------------------------------------- //
extern "C" int64_t spblas_rcm(int64_t m, int64_t nnz, const int64_t* rowptr,
                              const int32_t* colind, int64_t* out_perm) {
  // adjacency = A + A^T (structure only)
  std::vector<int64_t> t_cnt(m + 1, 0);
  for (int64_t e = 0; e < nnz; ++e) t_cnt[colind[e] + 1]++;
  for (int64_t j = 0; j < m; ++j) t_cnt[j + 1] += t_cnt[j];
  std::vector<int32_t> t_col(nnz);
  {
    std::vector<int64_t> cur(t_cnt.begin(), t_cnt.end() - 1);
    for (int64_t i = 0; i < m; ++i) {
      int64_t lo = std::min(rowptr[i], nnz), hi = std::min(rowptr[i + 1], nnz);
      for (int64_t e = lo; e < hi; ++e)
        t_col[cur[colind[e]]++] = static_cast<int32_t>(i);
    }
  }
  std::vector<int64_t> deg(m, 0);
  std::vector<int64_t> mark(m, -1);
  // degrees of the union graph (count neighbors once)
  auto for_neighbors = [&](int64_t i, auto&& fn) {
    int64_t lo = std::min(rowptr[i], nnz), hi = std::min(rowptr[i + 1], nnz);
    for (int64_t e = lo; e < hi; ++e) fn(colind[e]);
    for (int64_t e = t_cnt[i]; e < t_cnt[i + 1]; ++e) fn(t_col[e]);
  };
  for (int64_t i = 0; i < m; ++i) {
    int64_t d = 0;
    for_neighbors(i, [&](int64_t j) {
      if (j != i && mark[j] != i) {
        mark[j] = i;
        ++d;
      }
    });
    deg[i] = d;
  }
  std::fill(mark.begin(), mark.end(), -1);

  std::vector<int64_t> order;
  order.reserve(m);
  std::vector<uint8_t> visited(m, 0);
  std::vector<int64_t> nbrs;
  // nodes sorted by degree for start selection
  std::vector<int64_t> by_deg(m);
  for (int64_t i = 0; i < m; ++i) by_deg[i] = i;
  std::stable_sort(by_deg.begin(), by_deg.end(),
                   [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });
  size_t start_cursor = 0;
  while (order.size() < static_cast<size_t>(m)) {
    while (start_cursor < by_deg.size() && visited[by_deg[start_cursor]])
      ++start_cursor;
    int64_t root = by_deg[start_cursor];
    visited[root] = 1;
    size_t head = order.size();
    order.push_back(root);
    while (head < order.size()) {
      int64_t i = order[head++];
      nbrs.clear();
      for_neighbors(i, [&](int64_t j) {
        if (!visited[j]) {
          visited[j] = 1;
          nbrs.push_back(j);
        }
      });
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        return deg[a] < deg[b];
      });
      for (int64_t j : nbrs) order.push_back(j);
    }
  }
  std::reverse(order.begin(), order.end());
  std::vector<int64_t> rank(m);
  for (int64_t i = 0; i < m; ++i) {
    out_perm[i] = order[i];
    rank[order[i]] = i;
  }
  int64_t h = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t lo = std::min(rowptr[i], nnz), hi = std::min(rowptr[i + 1], nnz);
    for (int64_t e = lo; e < hi; ++e)
      h = std::max(h, std::abs(rank[i] - rank[colind[e]]));
  }
  return h;
}

// ------------------------------------------------------------------ //
// Fused SpGEMM expansion stream: row-major expansion of A@B (+D) with
// per-row column sort and dense output-slot numbering — the host side
// of the route2-mul numeric engine build (ops/spgemm.py
// _try_build_route).  Replaces a ~1M-element global argsort + numpy
// glue (round-3 profile: 0.42 s of the 2k reuse-engine build) with a
// single pass of per-row stable sorts: the expansion is naturally
// row-ordered, so only columns within a row need sorting.
//
// sa[k]/sb[k] are the A/B value-source indices of expansion element k
// in (row, col)-sorted order; D entries read the constant-1 slot a_cap
// and the beta*d region b_cap+t (reference 4-arg fused form,
// vendor/rocsparse/multiply_spgemm.hpp:232-317).  slots[k] is the
// dense output slot (unique (row, col) rank).  Returns result nnz, or
// -1 if the emitted count differs from e_total.
extern "C" int64_t spblas_mul_expand(
    int64_t m, int64_t a_nnz, const int64_t* a_rowptr,
    const int32_t* a_colind, int64_t b_nnz, const int64_t* b_rowptr,
    const int32_t* b_colind, int64_t d_nnz, const int64_t* d_rowptr,
    const int32_t* d_colind, int64_t a_cap, int64_t b_cap,
    int64_t e_total, int64_t* slots, int64_t* sa, int64_t* sb) {
  std::vector<int32_t> cols;
  std::vector<int64_t> lsa, lsb;
  std::vector<int32_t> order;
  int64_t out = 0;
  int64_t slot = -1;
  for (int64_t i = 0; i < m; ++i) {
    cols.clear(); lsa.clear(); lsb.clear();
    int64_t lo = std::min(a_rowptr[i], a_nnz);
    int64_t hi = std::min(a_rowptr[i + 1], a_nnz);
    for (int64_t e = lo; e < hi; ++e) {
      int32_t k = a_colind[e];
      int64_t blo = std::min(b_rowptr[k], b_nnz);
      int64_t bhi = std::min(b_rowptr[k + 1], b_nnz);
      for (int64_t f = blo; f < bhi; ++f) {
        cols.push_back(b_colind[f]);
        lsa.push_back(e);
        lsb.push_back(f);
      }
    }
    if (d_nnz) {
      int64_t dlo = std::min(d_rowptr[i], d_nnz);
      int64_t dhi = std::min(d_rowptr[i + 1], d_nnz);
      for (int64_t t = dlo; t < dhi; ++t) {
        cols.push_back(d_colind[t]);
        lsa.push_back(a_cap);
        lsb.push_back(b_cap + t);
      }
    }
    int64_t ne = (int64_t)cols.size();
    if (out + ne > e_total) return -1;
    order.resize(ne);
    for (int64_t k = 0; k < ne; ++k) order[k] = (int32_t)k;
    std::stable_sort(order.begin(), order.end(),
                     [&](int32_t x, int32_t y) {
                       return cols[x] < cols[y];
                     });
    int32_t prev = -1;
    bool first = true;
    for (int64_t k = 0; k < ne; ++k) {
      int32_t o = order[k];
      if (first || cols[o] != prev) { ++slot; prev = cols[o]; }
      first = false;
      slots[out] = slot;
      sa[out] = lsa[o];
      sb[out] = lsb[o];
      ++out;
    }
  }
  if (out != e_total) return -1;
  return slot + 1;
}
