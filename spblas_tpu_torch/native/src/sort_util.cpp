// Host-side sort/scatter utilities for the ROUTE2 plan builders.
//
// Profiling the m=1M deg-10 SpMV inspect (round 4) put the native cell
// packer at ~8% of the build; the other 92% was single-threaded numpy:
// packed-key construction (~2.6 s), the stable argsort (~1.8 s), the
// post-sort gathers (~2.2 s) and the group-tile scatter (~1.7 s).
// These three entry points move that pipeline to multithreaded C++
// (4 host cores): parallel key build, parallel stable LSD radix
// argsort (emitting both the order and the sorted keys), and the
// group-tile fill.  All are semantics-identical to the numpy
// expressions they replace (stable order ⇒ bit-identical plans).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int nthreads_for(int64_t n) {
  unsigned hw = std::thread::hardware_concurrency();
  int t = hw ? (int)hw : 1;
  if (t > 8) t = 8;
  // below ~1M elements thread spawn + barrier overhead dominates
  while (t > 1 && n / t < 262144) --t;
  return t;
}

template <typename F>
void parallel_blocks(int64_t n, int nt, F&& body) {
  if (nt <= 1) {
    body(0, 0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t b0 = t * per, b1 = std::min<int64_t>(n, b0 + per);
    if (b0 >= b1) break;
    ts.emplace_back([&, t, b0, b1] { body(t, b0, b1); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

// key[i] = (cell_id << (15 + rw_bits)) | (lrow << 15) | lcol with
//   cell_id = (rows >> rw_bits) * ncellc + (cols >> w_bits) [+ lvl*mult]
//   lrow = rows & (2^rw_bits - 1),  lcol = cols & (2^w_bits - 1)
// (the route2.py _pack_stream packed sort key; lcol rides the fixed
// 15-bit field so it can be recovered independently of w_bits).
extern "C" void spblas_route2_keys(
    int64_t n, const int64_t* rows, const int64_t* cols,
    int32_t rw_bits, int32_t w_bits, int64_t ncellc,
    const int64_t* lvl, int64_t lvl_mult, int64_t* key) {
  const int64_t rw_mask = ((int64_t)1 << rw_bits) - 1;
  const int64_t w_mask = ((int64_t)1 << w_bits) - 1;
  const int shift = 15 + rw_bits;
  int nt = nthreads_for(n);
  parallel_blocks(n, nt, [&](int, int64_t b0, int64_t b1) {
    if (lvl) {
      for (int64_t i = b0; i < b1; ++i) {
        int64_t cell = (rows[i] >> rw_bits) * ncellc + (cols[i] >> w_bits)
                       + lvl[i] * lvl_mult;
        key[i] = (cell << shift) | ((rows[i] & rw_mask) << 15)
                 | (cols[i] & w_mask);
      }
    } else {
      for (int64_t i = b0; i < b1; ++i) {
        int64_t cell = (rows[i] >> rw_bits) * ncellc + (cols[i] >> w_bits);
        key[i] = (cell << shift) | ((rows[i] & rw_mask) << 15)
                 | (cols[i] & w_mask);
      }
    }
  });
}

// Stable LSD radix argsort of non-negative int64 keys; fills order
// (int32) and sorted_key.  Identical order to np.argsort(key,
// kind="stable").  Returns 0, or -1 when n does not fit int32.
extern "C" int64_t spblas_argsort_i64(
    int64_t n, const int64_t* key, int32_t* order, int64_t* sorted_key) {
  if (n >= INT32_MAX) return -1;
  if (n == 0) return 0;
  int nt = nthreads_for(n);

  // max key -> number of 8-bit passes.  The same scan rejects negative
  // keys (return -2 -> callers fall back to np.argsort): LSD radix on
  // two's-complement would SILENTLY order negatives after positives,
  // and a caller's packed-key overflow must not become a mis-sorted
  // plan.
  std::vector<int64_t> mx(nt ? nt : 1, 0);
  std::vector<int64_t> mn(nt ? nt : 1, 0);
  parallel_blocks(n, nt, [&](int t, int64_t b0, int64_t b1) {
    int64_t m = 0, lo = 0;
    for (int64_t i = b0; i < b1; ++i) {
      if (key[i] > m) m = key[i];
      if (key[i] < lo) lo = key[i];
    }
    mx[t] = m;
    mn[t] = lo;
  });
  for (int64_t v : mn)
    if (v < 0) return -2;
  int64_t maxkey = 0;
  for (int64_t v : mx) maxkey = std::max(maxkey, v);
  int passes = 1;
  while (passes < 8 && (maxkey >> (8 * passes)) != 0) ++passes;

  std::vector<int64_t> kbuf_a(n), kbuf_b(n);
  std::vector<int32_t> ibuf_a(n), ibuf_b(n);
  std::memcpy(kbuf_a.data(), key, n * sizeof(int64_t));
  parallel_blocks(n, nt, [&](int, int64_t b0, int64_t b1) {
    for (int64_t i = b0; i < b1; ++i) ibuf_a[i] = (int32_t)i;
  });

  int64_t* kin = kbuf_a.data();
  int64_t* kout = kbuf_b.data();
  int32_t* iin = ibuf_a.data();
  int32_t* iout = ibuf_b.data();

  std::vector<std::vector<int64_t>> cnt(nt, std::vector<int64_t>(256));
  for (int p = 0; p < passes; ++p) {
    const int sh = 8 * p;
    for (auto& c : cnt) std::fill(c.begin(), c.end(), 0);
    parallel_blocks(n, nt, [&](int t, int64_t b0, int64_t b1) {
      int64_t* c = cnt[t].data();
      for (int64_t i = b0; i < b1; ++i) ++c[(kin[i] >> sh) & 255];
    });
    // skip pass if every key shares this digit
    int64_t dom = 0;
    for (int d = 0; d < 256; ++d) {
      int64_t tot = 0;
      for (int t = 0; t < nt; ++t) tot += cnt[t][d];
      if (tot == n) { dom = 1; break; }
      if (tot) break;  // cheap early-out only valid for d with counts
    }
    if (dom) continue;
    // exclusive prefix over (digit major, thread minor) -> stable
    int64_t run = 0;
    for (int d = 0; d < 256; ++d)
      for (int t = 0; t < nt; ++t) {
        int64_t c = cnt[t][d];
        cnt[t][d] = run;
        run += c;
      }
    parallel_blocks(n, nt, [&](int t, int64_t b0, int64_t b1) {
      int64_t* pos = cnt[t].data();
      for (int64_t i = b0; i < b1; ++i) {
        int64_t j = pos[(kin[i] >> sh) & 255]++;
        kout[j] = kin[i];
        iout[j] = iin[i];
      }
    });
    std::swap(kin, kout);
    std::swap(iin, iout);
  }
  std::memcpy(order, iin, n * sizeof(int32_t));
  std::memcpy(sorted_key, kin, n * sizeof(int64_t));
  return 0;
}

// Group val/src tile fill: vt[group*1024 + scat] = vals[i],
// st[...] = ent[i] (>=0) or -1, skipping the spilled stream indices.
// Targets are unique per element (each committed element owns one
// (group, depth, lane) slot), so the parallel scatter is race-free.
// vt/st arrive UNINITIALIZED (np.empty) and are initialized here
// (threaded; np.full on the (ngroup, 8, 128) st was 2.2 s at m=4M).
extern "C" void spblas_fill_group_tiles(
    int64_t ne, const int32_t* elem_group, const int32_t* elem_scat,
    const float* vals, const int64_t* ent,
    int64_t n_spill, const int32_t* spill_idx, int64_t ngroup,
    float* vt, int32_t* st) {
  int64_t slots = ngroup * 1024;
  parallel_blocks(slots, nthreads_for(slots),
                  [&](int, int64_t b0, int64_t b1) {
    std::memset(vt + b0, 0, (b1 - b0) * sizeof(float));
    std::memset(st + b0, 0xff, (b1 - b0) * sizeof(int32_t));
  });
  std::vector<uint8_t> skip;
  if (n_spill) {
    skip.assign(ne, 0);
    for (int64_t k = 0; k < n_spill; ++k) skip[spill_idx[k]] = 1;
  }
  const uint8_t* sk = n_spill ? skip.data() : nullptr;
  int nt = nthreads_for(ne);
  parallel_blocks(ne, nt, [&](int, int64_t b0, int64_t b1) {
    for (int64_t i = b0; i < b1; ++i) {
      if (sk && sk[i]) continue;
      int64_t off = (int64_t)elem_group[i] * 1024 + elem_scat[i];
      vt[off] = vals[i];
      st[off] = ent[i] >= 0 ? (int32_t)ent[i] : -1;
    }
  });
}

// Threaded gathers: dst[i] = src[idx[i]].  The numpy fancy-gather of
// the (nch, 8, 128) group val/src tiles ran at ~215 MB/s single-core
// (1.3 s of the m=1M build); these run at memcpy speed across cores.
extern "C" void spblas_gather_f32(int64_t n, const int32_t* idx,
                                  const float* src, float* dst) {
  parallel_blocks(n, nthreads_for(n), [&](int, int64_t b0, int64_t b1) {
    for (int64_t i = b0; i < b1; ++i) dst[i] = src[idx[i]];
  });
}

extern "C" void spblas_gather_i64(int64_t n, const int32_t* idx,
                                  const int64_t* src, int64_t* dst) {
  parallel_blocks(n, nthreads_for(n), [&](int, int64_t b0, int64_t b1) {
    for (int64_t i = b0; i < b1; ++i) dst[i] = src[idx[i]];
  });
}

// 4 KB-tile gather (one (8,128) int32/f32 tile per index)
extern "C" void spblas_gather_tiles(int64_t n, const int32_t* idx,
                                    const void* src, void* dst) {
  const char* s = (const char*)src;
  char* d = (char*)dst;
  int nt = nthreads_for(n * 512);
  parallel_blocks(n, nt, [&](int, int64_t b0, int64_t b1) {
    for (int64_t i = b0; i < b1; ++i)
      std::memcpy(d + i * 4096, s + (int64_t)idx[i] * 4096, 4096);
  });
}

// rows[k] = r for rowptr[r] <= k < rowptr[r+1] (np.repeat(arange(m),
// diff(rowptr)) — 0.5 s of the m=1M build single-threaded)
extern "C" void spblas_expand_rowptr(int64_t m, int64_t nnz,
                                     const int64_t* rowptr,
                                     int64_t* rows) {
  int nt = nthreads_for(nnz);
  parallel_blocks(nnz, nt, [&](int, int64_t b0, int64_t b1) {
    // first row whose range contains b0
    int64_t r = std::upper_bound(rowptr, rowptr + m + 1, b0)
                - rowptr - 1;
    if (r < 0) r = 0;
    for (int64_t k = b0; k < b1; ++k) {
      while (r + 1 <= m && rowptr[r + 1] <= k) ++r;
      rows[k] = r;
    }
  });
}

// Pad-aware 4 KB-tile gather: idx < 0 takes the fill tile (the paned
// regroup inserts CB-alignment pad chunks between pane runs)
extern "C" void spblas_gather_tiles_fill(
    int64_t n, const int32_t* idx, const void* src, const void* fill,
    void* dst) {
  const char* s = (const char*)src;
  char* d = (char*)dst;
  int nt = nthreads_for(n * 512);
  parallel_blocks(n, nt, [&](int, int64_t b0, int64_t b1) {
    for (int64_t i = b0; i < b1; ++i) {
      if (idx[i] < 0)
        std::memcpy(d + i * 4096, fill, 4096);
      else
        std::memcpy(d + i * 4096, s + (int64_t)idx[i] * 4096, 4096);
    }
  });
}
