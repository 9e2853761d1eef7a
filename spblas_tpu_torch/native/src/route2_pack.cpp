// Native ROUTE2 chunk packer — the hot loop of
// spblas_tpu/kernels/route2.py::_pack_cell, semantics-identical to the
// python packer (FFD segment order, open-chunk pool with retire-coldest,
// incremental greedy edge coloring, lane-matched aux slots).
//
// Tile bit layout (must match route2.py):
//   r2   [0:8)   at (a, l)       lf  [8:15)  at (a, jd)
//   sd2  [15:18) at (d, jd)      dist[18:21) at (d, jd)
//   pend [21:24) at final slot   vA  [24:25) at final slot
//   lsrc [25:32) ANY-LANE publish: at the publish slot (s, l), the
//                accumulation lane the publish reads its segment sum
//                from; its pend field rides the CARRIER slot
//                (s, lsrc).  The kernel takes depth per lane first
//                (pend), then lane-gathers by lsrc — so segments may
//                accumulate at ANY lane with free depth instead of
//                serializing on lane row&127 (the Poisson fill wall,
//                round 3).  Each (s, acc_lane) carrier serves ONE
//                direct publish; aux publishes are lane-matched so
//                their carrier is their own slot.
// r2 = col >> 7 is the column's FULL slab row; columns congruent
// mod 1024 no longer conflict (no sel class table).
//
// Interface (all buffers caller-allocated):
//   returns nchunks, or -1 when max_chunks was too small (caller grows
//   and retries), or -2 on internal error.

#include <array>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

constexpr int LANES = 128;
constexpr int SUBS = 8;
constexpr int SLOTS = 1024;
constexpr int MAX_OPEN = 24;
// rows with more than HUB_T elements in one cell route their segments
// past the first straight to the aux region ACROSS lanes: a hub row's
// elements all share scatter lane (row & 127), so direct placement
// serializes one 8-deep segment per chunk (the RMAT fill collapse);
// aux segments may stack at any lane and reduce in-dispatch.
constexpr int HUB_T = 16;

constexpr int B_R2 = 0, B_LF = 8, B_SD2 = 15, B_DIST = 18,
              B_PEND = 21, B_VA = 24, B_LSRC = 25;
// supercell mode (round 4): home-lane plans reuse the (unused) lsrc
// bit range to carry a 3-bit publish sub-window — one chunk then
// publishes into an up-to-8192-row window (8 stacked (8,128) tiles),
// lifting the per-cell chunk-quantization fill wall.  Mutually
// exclusive with any-lane (B_LSRC needs all 7 bits).
constexpr int B_SUBW = 29;
constexpr int MAX_ROW_WINDOW = 8 * SLOTS;

// sel: rotation-class selector (rotate mode, round 5) — braced inits
// with three members zero it
struct Pub { int32_t slot; int16_t jd; int16_t pend; int16_t sel; };
// rotate mode: publish-class selector bit (home-lane supercell plans
// keep subw at 29-31; bit 28 carries which of the chunk's two
// rotations this publish used)
constexpr int B_SEL = 28;
struct AuxPub { int64_t abs_slot; int16_t jd; int16_t pend;
                int32_t lrow; int32_t cell; };
struct Elem { int32_t col; int32_t idx; int16_t jd; int8_t d;
              int8_t dist; };

// global aux allocator: per window, per lane depth.  Allocation is
// TAIL-ONLY and happens at chunk-flush time so one chunk's aux pubs
// stay window-coherent — each distinct window a chunk publishes into
// costs a duplicate chunk emission, so coherence is a fill lever.
struct AuxAlloc {
  std::vector<std::array<int8_t, LANES>> windows;
  int64_t alloc_tail(int jd) {
    if (windows.empty() || windows.back()[jd] >= SUBS) {
      windows.emplace_back();
      windows.back().fill(0);
    }
    size_t w = windows.size() - 1;
    int d = windows[w][jd]++;
    return (int64_t)w * SLOTS + d * LANES + jd;
  }
};

// open-addressing edge/color hashes shared by the SpMV Chunk and the
// mul-engine MulSide — ONE copy (a probing or sizing fix must hit
// both).  edge hash: key = col*128+jd -> color; colcolor hash:
// col -> color mask.
struct EdgeColorHash {
  static constexpr int EH = 4096;  // power of two, >= 2*1024
  int64_t eh_key[EH]; int8_t eh_val[EH];
  static constexpr int CH = 2048;
  int32_t ch_key[CH]; uint8_t ch_val[CH];

  void reset_tables() {
    std::memset(eh_key, -1, sizeof eh_key);
    std::memset(ch_key, -1, sizeof ch_key);
  }
  int eh_find(int64_t key) const {
    int h = (int)((key * 0x9E3779B97F4A7C15ull) >> 52) & (EH - 1);
    while (eh_key[h] != -1) {
      if (eh_key[h] == key) return eh_val[h];
      h = (h + 1) & (EH - 1);
    }
    return -1;
  }
  void eh_insert(int64_t key, int a) {
    int h = (int)((key * 0x9E3779B97F4A7C15ull) >> 52) & (EH - 1);
    while (eh_key[h] != -1) {
      if (eh_key[h] == key) { eh_val[h] = (int8_t)a; return; }
      h = (h + 1) & (EH - 1);
    }
    eh_key[h] = key; eh_val[h] = (int8_t)a;
  }
  uint8_t ch_get(int32_t col) const {
    int h = (int)((uint32_t)col * 2654435761u >> 21) & (CH - 1);
    while (ch_key[h] != -1) {
      if (ch_key[h] == col) return ch_val[h];
      h = (h + 1) & (CH - 1);
    }
    return 0;
  }
  void ch_or(int32_t col, uint8_t bit) {
    int h = (int)((uint32_t)col * 2654435761u >> 21) & (CH - 1);
    while (ch_key[h] != -1) {
      if (ch_key[h] == col) { ch_val[h] |= bit; return; }
      h = (h + 1) & (CH - 1);
    }
    ch_key[h] = col; ch_val[h] = bit;
  }
};

struct Chunk : EdgeColorHash {
  uint8_t acl[LANES], acj[LANES];  // bitmask over colors a
  int8_t depth[LANES];
  uint64_t rows_pub[MAX_ROW_WINDOW / 64];  // bitmask over local rows
  // any-lane pend carriers: bitmask over (pub_sublane, acc_lane) —
  // one direct publish per carrier slot (aux pubs are lane-matched
  // and carry pend at their own slot, no bookkeeping needed)
  uint64_t carrier[16];
  // per-chunk publish-position rotations (rotate mode, round 5):
  // publish pos = ((lr & 1023) + rho[sel]) & 1023 — each chunk
  // re-hashes the 1024-class collisions AND the per-lane load
  int32_t rho[2];
  std::vector<Elem> elems;
  std::vector<Pub> pubs;
  std::vector<AuxPub> aux_pubs;
  int64_t cold = 0;

  void reset() {
    std::memset(acl, 0, sizeof acl);
    std::memset(acj, 0, sizeof acj);
    std::memset(depth, 0, sizeof depth);
    std::memset(rows_pub, 0, sizeof rows_pub);
    std::memset(carrier, 0, sizeof carrier);
    rho[0] = rho[1] = 0;
    reset_tables();
    elems.clear(); pubs.clear(); aux_pubs.clear();
    cold = 0;
  }
  bool carrier_free(int s_pub, int jd) const {
    int b = s_pub * LANES + jd;
    return !((carrier[b >> 6] >> (b & 63)) & 1);
  }
  void carrier_set(int s_pub, int jd) {
    int b = s_pub * LANES + jd;
    carrier[b >> 6] |= 1ull << (b & 63);
  }
  bool row_published(int r) const {
    return (rows_pub[r >> 6] >> (r & 63)) & 1;
  }
  void set_row_published(int r) { rows_pub[r >> 6] |= 1ull << (r & 63); }

  // longest feasible PREFIX of the segment at lane jd (depth- and
  // color-capped); fills as_* with the prefix's new-edge assignments
  // and *nas with their count; returns the prefix length 0..len.
  // All-or-nothing placement made one saturated lane reject whole
  // segments and cascade near-empty chunks on dense cells.
  int route_prefix(const int32_t* cols, int len, int jd,
                   int32_t* as_col, int8_t* as_a, uint8_t* as_new,
                   int* nas) {
    int cap = SUBS - depth[jd];
    if (len > cap) len = cap;
    int n = 0, p = 0;
    uint8_t taken_j = 0;
    for (int k = 0; k < len; ++k) {
      int32_t c = cols[k];
      int l = c & 127;
      int64_t ekey = (int64_t)c * 128 + jd;
      if (eh_find(ekey) >= 0) { ++p; continue; }
      bool dup = false;
      for (int t = 0; t < n; ++t)
        if (as_col[t] == c) { dup = true; break; }
      if (dup) { ++p; continue; }
      uint8_t colors = ch_get(c);
      int a_found = -1;
      uint8_t free_j = (uint8_t)~(acj[jd] | taken_j);
      uint8_t reuse = colors & free_j;
      uint8_t isnew = 0;
      if (reuse) {
        a_found = __builtin_ctz(reuse);
      } else {
        uint8_t avail = (uint8_t)(~acl[l]) & free_j;
        if (!avail) break;
        a_found = __builtin_ctz(avail);
        isnew = 1;
      }
      taken_j |= (uint8_t)(1 << a_found);
      as_col[n] = c; as_a[n] = (int8_t)a_found; as_new[n] = isnew;
      ++n; ++p;
    }
    *nas = n;
    return p;
  }

  int commit(const int32_t* cols, const int32_t* idxs, int len, int jd,
             const int32_t* as_col, const int8_t* as_a,
             const uint8_t* as_new, int nas) {
    cold = 0;
    for (int t = 0; t < nas; ++t) {
      int32_t c = as_col[t];
      int l = c & 127;
      int a = as_a[t];
      eh_insert((int64_t)c * 128 + jd, a);
      acj[jd] |= (uint8_t)(1 << a);
      if (as_new[t]) {
        acl[l] |= (uint8_t)(1 << a);
        ch_or(c, (uint8_t)(1 << a));
      }
    }
    int d0 = depth[jd];
    for (int k = 0; k < len; ++k) {
      elems.push_back({cols[k], idxs[k], (int16_t)jd, (int8_t)(d0 + k),
                       (int8_t)(k > 7 ? 7 : k)});
    }
    depth[jd] = (int8_t)(d0 + len);
    return d0 + len - 1;
  }
};

// Thread-local output: chunks grow in vectors and are merged into the
// caller's buffers in cell order after the parallel cell sweep (cells
// are independent — the pool flushes at every cell boundary — so
// per-cell packing is identical to the sequential packer; only aux
// WINDOW INDICES shift, because a tail window open at a thread
// boundary closes instead of being continued by the next cell).
struct Out {
  std::vector<int32_t> tiles;       // nch * 1024
  std::vector<int32_t> chunk_cell;  // auxwin: -1 direct, else window
  std::vector<int32_t> chunk_auxwin;
  std::vector<int32_t> chunk_group; // shared val-tile group
  std::vector<int32_t> chunk_rho;   // rho0 | rho1 << 10 (0 = identity)
  int32_t* elem_chunk;              // SHARED: disjoint element writes
  int32_t* elem_scat;               // per element: d*128 + jd
  int64_t nch = 0, ngroup = 0;

  int32_t* add(int cell, int auxwin, int group, int32_t rho = 0) {
    chunk_cell.push_back(cell);
    chunk_auxwin.push_back(auxwin);
    chunk_group.push_back(group);
    chunk_rho.push_back(rho);
    size_t need = (size_t)(nch + 1) * SLOTS;
    if (tiles.capacity() < need)
      tiles.reserve(std::max(need, tiles.capacity() * 2));
    tiles.resize(need);
    int32_t* t = tiles.data() + nch * SLOTS;
    std::memset(t, 0, SLOTS * sizeof(int32_t));
    ++nch;
    return t;
  }
};

int pack_threads_for(int64_t ne, int64_t ncells) {
  unsigned hw = std::thread::hardware_concurrency();
  int t = hw ? (int)hw : 1;
  if (t > 8) t = 8;
  if ((int64_t)t > ncells) t = (int)(ncells > 0 ? ncells : 1);
  while (t > 1 && ne / t < 200000) --t;
  return t;
}

// cell-range split balanced by element count (cells stay whole)
std::vector<int64_t> split_cells(int64_t ncells, const int64_t* cell_start,
                                 int64_t ne, int nt) {
  std::vector<int64_t> cuts(nt + 1, ncells);
  cuts[0] = 0;
  int64_t c = 0;
  for (int t = 1; t < nt; ++t) {
    int64_t target = ne * t / nt;
    while (c < ncells && cell_start[c] < target) ++c;
    cuts[t] = c;
  }
  return cuts;
}

bool flush_chunk(Chunk& ck, int cell, Out& out,
                 std::vector<AuxPub>* aux_pending, AuxAlloc* aux,
                 int row_window = SLOTS, int32_t rotate = 0) {
  if (ck.elems.empty() && ck.pubs.empty() && ck.aux_pubs.empty())
    return true;
  int group = (int)out.ngroup++;
  // base tile: gather/route/scatter fields (shared by all copies)
  int32_t base[SLOTS];
  std::memset(base, 0, sizeof base);
  for (int h = 0; h < Chunk::EH; ++h) {
    if (ck.eh_key[h] == -1) continue;
    int64_t key = ck.eh_key[h];
    int a = ck.eh_val[h];
    int32_t c = (int32_t)(key >> 7);
    int jd = (int)(key & 127);
    int l = c & 127;
    base[a * LANES + l] |= (int32_t)((c >> 7) << B_R2);
    base[a * LANES + jd] |= (int32_t)(l << B_LF);
  }
  for (const Elem& e : ck.elems) {
    int64_t ekey = (int64_t)e.col * 128 + e.jd;
    int a = ck.eh_find(ekey);
    base[e.d * LANES + e.jd] |=
        (int32_t)((a << B_SD2) | (e.dist << B_DIST));
  }
  // direct copy: publish slot gets valid bit + acc lane (lsrc); its
  // pend rides the carrier slot (pub_sublane, acc_lane)
  if (!ck.pubs.empty() || ck.aux_pubs.empty()) {
    int32_t rho_packed = rotate
        ? (int32_t)(ck.rho[0] | (ck.rho[1] << 10)) : 0;
    int32_t* t = out.add(cell, -1, group, rho_packed);
    if (!t) return false;
    std::memcpy(t, base, sizeof base);
    for (const Pub& p : ck.pubs) {
      // supercell (row_window > SLOTS): publish lands at the row's
      // 1024-class tile position, with the sub-window id in the lsrc
      // bit range (home-lane only, so lsrc is free); rotate mode
      // shifts the position by the chunk's rho[sel] and stores sel
      int local = p.slot & (SLOTS - 1);
      int32_t hi;
      if (rotate) {
        local = (local + ck.rho[p.sel]) & (SLOTS - 1);
        hi = (int32_t)(((uint32_t)(p.slot / SLOTS) << B_SUBW)
                       | ((uint32_t)p.sel << B_SEL));
      } else {
        hi = row_window == SLOTS
            ? (int32_t)((uint32_t)p.jd << B_LSRC)
            : (int32_t)((uint32_t)(p.slot / SLOTS) << B_SUBW);
      }
      t[local] |= (int32_t)(1u << B_VA) | hi;
      t[(local >> 7) * LANES + p.jd] |=
          (int32_t)(p.pend << B_PEND);
    }
  }
  // aux copies, one per distinct window (slots allocated here, from
  // the allocator tail, so this chunk's pubs share windows)
  if (!ck.aux_pubs.empty()) {
    for (AuxPub& p : ck.aux_pubs)
      p.abs_slot = aux->alloc_tail(p.jd);
    std::vector<std::pair<int64_t, const AuxPub*>> bywin;
    for (const AuxPub& p : ck.aux_pubs)
      bywin.push_back({p.abs_slot / SLOTS, &p});
    std::sort(bywin.begin(), bywin.end(),
              [](auto& a, auto& b) { return a.first < b.first; });
    size_t i = 0;
    while (i < bywin.size()) {
      int64_t w = bywin[i].first;
      int32_t* t = out.add(cell, (int32_t)w, group);
      if (!t) return false;
      std::memcpy(t, base, sizeof base);
      for (; i < bywin.size() && bywin[i].first == w; ++i) {
        const AuxPub* p = bywin[i].second;
        int local = (int)(p->abs_slot - w * SLOTS);
        // lane-matched aux slot: its carrier is itself (lsrc = lane);
        // supercell AND rotate plans must keep the lsrc range clear
        // (the kernel reads it as sub-window / sel, which must be 0
        // for aux tiles — aux copies also carry rho = 0)
        int32_t hi = (row_window == SLOTS && !rotate)
            ? (int32_t)((uint32_t)(local & 127) << B_LSRC) : 0;
        t[local] |= (int32_t)((p->pend << B_PEND) | (1u << B_VA)) | hi;
      }
    }
  }
  // element group/scatter maps
  for (const Elem& e : ck.elems) {
    out.elem_chunk[e.idx] = group;
    out.elem_scat[e.idx] = e.d * LANES + e.jd;
  }
  if (aux_pending)
    for (AuxPub p : ck.aux_pubs) {
      p.cell = cell;
      aux_pending->push_back(p);
    }
  return true;
}

}  // namespace

extern "C" int64_t spblas_route2_pack(
    int64_t ne, int64_t ncells, const int64_t* cell_start,
    const int32_t* lrow, const int32_t* lcol, int64_t max_chunks,
    int64_t aux_windows_in, int32_t spill_only,
    int32_t* tiles, int32_t* chunk_cell, int32_t* chunk_auxwin,
    int32_t* chunk_group, int32_t* elem_chunk, int32_t* elem_scat,
    int64_t* aux_info,            // out: [0]=n_pending [1]=n_windows
    int64_t* aux_slot,            // out per pending: absolute slot
    int32_t* aux_lrow,            // out per pending: local row
    int32_t* aux_cell,            // out per pending: cell index
    // optional overflow spill (nullptr = legacy behavior): when a cell
    // would open more chunks than its element count deserves (the
    // Poisson-tail overflow that fragments per-cell chunks), the
    // segment's elements are emitted to spill_out (stream indices)
    // for window-major repacking by the caller instead
    int32_t* spill_out, int64_t* spill_n, int32_t spill_enable,
    // any_lane=0 restricts direct publishes to their home lane
    // (row & 127): the emitted tiles then have lsrc == own lane, so the
    // kernel can skip the B_LSRC gather (plan.any_lane=False).  Packing
    // fill drops on starved cell grids but each chunk is ~15 ns cheaper
    // (round-3 A/B: home wins <= ~1024-elem cells, any-lane below).
    int32_t any_lane,
    // row_window (SLOTS..8*SLOTS, round 4): supercell height — local
    // rows span this many slots, publishes carry a sub-window id in
    // the lsrc bit range (requires any_lane=0)
    int32_t row_window,
    // rotate (round 5): per-chunk d=2 publish-position rotations
    // (requires any_lane=0); chunk_rho receives rho0 | rho1 << 10
    // per emitted chunk (0 for aux copies)
    int32_t rotate, int32_t* chunk_rho);

namespace {

// one thread's share of the cell sweep; cells are packed exactly as in
// the sequential sweep (the pool flushes at every cell boundary)
bool pack_cells_range(
    const int64_t* cell_start, const int32_t* lrow, const int32_t* lcol,
    int64_t c_begin, int64_t c_end, int32_t spill_only,
    int32_t spill_enable, int32_t any_lane, int32_t row_window,
    int32_t rotate,
    Out& out, AuxAlloc& aux, std::vector<AuxPub>& pending,
    std::vector<int32_t>& spill) {
  std::vector<Chunk> pool_store(MAX_OPEN + 1);
  for (auto& c : pool_store) c.reset();

  std::vector<int> seg_start, seg_len, seg_row, seg_order;
  std::vector<uint8_t> seg_hub;
  for (int64_t cell = c_begin; cell < c_end; ++cell) {
    int64_t a0 = cell_start[cell], a1 = cell_start[cell + 1];
    if (a0 >= a1) continue;
    // chunk budget: what the cell's element count deserves at ~70%
    // fill, minimum 1 (spill disabled when spill_out == nullptr)
    int64_t cell_budget = spill_enable
        ? ((a1 - a0) + 716) / 717 : (int64_t)1 << 60;
    int64_t cell_opened = 0;
    // --- segment formation (<=8 per row run) + hub marking ---
    seg_start.clear(); seg_len.clear(); seg_row.clear(); seg_hub.clear();
    {
      int64_t i = a0;
      while (i < a1) {
        int32_t row = lrow[i];
        int64_t e = i;
        while (e < a1 && lrow[e] == row) ++e;
        int total = (int)(e - i);
        int ord = 0;
        for (int64_t st = i; st < e; st += SUBS) {
          seg_start.push_back((int)(st - a0));
          seg_len.push_back((int)std::min<int64_t>(SUBS, e - st));
          seg_row.push_back(row);
          seg_hub.push_back(total > HUB_T && ord > 0 ? 1 : 0);
          ++ord;
        }
        i = e;
      }
    }
    int nseg = (int)seg_start.size();
    seg_order.resize(nseg);
    for (int s = 0; s < nseg; ++s) seg_order[s] = s;
    std::stable_sort(seg_order.begin(), seg_order.end(),
                     [&](int x, int y) {
                       return seg_len[x] > seg_len[y];
                     });

    std::vector<int> open;          // indices into pool_store
    std::vector<int> freelist;
    for (int i2 = 0; i2 <= MAX_OPEN; ++i2) freelist.push_back(i2);

    int32_t segc[SUBS]; int32_t segi[SUBS];
    int32_t as_col[SUBS]; int8_t as_a[SUBS]; uint8_t as_new[SUBS];

    auto flush_at = [&](int pos) -> bool {
      int id = open[pos];
      bool ok = flush_chunk(pool_store[id], (int)cell, out, &pending,
                            &aux, row_window, rotate);
      pool_store[id].reset();
      freelist.push_back(id);
      open.erase(open.begin() + pos);
      return ok;
    };

    for (int oi = 0; oi < nseg; ++oi) {
      int s = seg_order[oi];
      int len = seg_len[s];
      int row = seg_row[s];
      for (int k = 0; k < len; ++k) {
        segc[k] = lcol[a0 + seg_start[s] + k];
        segi[k] = (int32_t)(a0 + seg_start[s] + k);
      }
      int jd = row & 127;
      bool hub = seg_hub[s] != 0;
      int off = 0;                   // elements of this segment placed

      auto open_fresh = [&]() -> Chunk* {
        if ((int)open.size() >= MAX_OPEN) {
          size_t coldest = 0;
          for (size_t p = 1; p < open.size(); ++p)
            if (pool_store[open[p]].cold >
                pool_store[open[coldest]].cold)
              coldest = p;
          if (!flush_at((int)coldest)) return nullptr;
        }
        int id = freelist.back(); freelist.pop_back();
        open.push_back(id);
        ++cell_opened;
        Chunk* c = &pool_store[id];
        if (rotate) {
          // deterministic per-(cell, open-ordinal) rotations so
          // rebuilds are bit-identical.  SUBLANE-ONLY (multiples of
          // 128): the packing sim showed full/lane/sublane rotations
          // all reach the same fill, and the sublane un-rotation is a
          // single in-kernel sublane gather (~3 ns vs ~15 for the
          // lane+carry form).  The two rotations are kept distinct.
          uint32_t h = (uint32_t)(cell * 2654435761u)
                       ^ (uint32_t)(cell_opened * 0x85EBCA77u);
          int r0 = (int)((h >> 8) & 7);
          int r1 = (r0 + 1 + (int)((h >> 20) % 7)) & 7;
          c->rho[0] = r0 << 7;
          c->rho[1] = r1 << 7;
        }
        return c;
      };

      // overflow spill: beyond the cell's chunk budget, emit the
      // remaining elements for window-major repacking.  Zero the
      // spilled entries' group slots too: downstream skips them via
      // spill_idx, but the merge phase blindly adds a thread offset to
      // every elem_chunk in its range and must not do arithmetic on
      // indeterminate np.empty bytes (UB under signed overflow).
      auto spill_rest = [&](int off2) {
        for (int k = off2; k < len; ++k) {
          int64_t idx = a0 + seg_start[s] + k;
          spill.push_back((int32_t)idx);
          out.elem_chunk[idx] = 0;
          out.elem_scat[idx] = 0;
        }
      };

      // ---- direct publish of the segment head (non-hub, non-spill):
      // ANY-LANE placement (round 3) — the B_LSRC carrier frees the
      // publish from its home lane, so the segment takes the first
      // lane with depth + colors + carrier room.  Home lane first
      // (cheap, keeps low-congestion plans legacy-shaped), then a
      // rotating probe across every open chunk.
      if (!hub && !spill_only) {
        int nopen = (int)open.size();
        int nas = 0;
        // carrier tracks the publish TILE POSITION (1024-class): for
        // supercells this doubles as the position-collision guard (two
        // rows congruent mod 1024 cannot both publish in one chunk);
        // rotate mode shifts the position per chunk, dissolving the
        // class into a per-chunk re-hash
        int s_pub = (row & (SLOTS - 1)) >> 7;
        auto try_direct = [&](Chunk& ck, int jd2, int sp2,
                              int sel) -> bool {
          if (ck.depth[jd2] + len > SUBS) return false;
          if (!ck.carrier_free(sp2, jd2)) return false;
          int pr = ck.route_prefix(segc, len, jd2, as_col, as_a,
                                   as_new, &nas);
          if (pr < len) return false;
          int pend = ck.commit(segc, segi, len, jd2, as_col, as_a,
                               as_new, nas);
          ck.carrier_set(sp2, jd2);
          ck.pubs.push_back({row, (int16_t)jd2, (int16_t)pend,
                             (int16_t)sel});
          ck.set_row_published(row);
          off = len;
          return true;
        };
        auto try_rot = [&](Chunk& ck) -> bool {
          for (int sel = 0; sel < 2 && off == 0; ++sel) {
            int pos = ((row & (SLOTS - 1)) + ck.rho[sel])
                      & (SLOTS - 1);
            try_direct(ck, pos & 127, pos >> 7, sel);
          }
          return off != 0;
        };
        // FIRST-FIT over chunks in insertion order (fullest first —
        // emptiest-first equalized chunks and tripled the per-cell
        // count, round-3 single-cell diagnostic); per chunk: home
        // lane, then a hashed any-lane probe (<=16 viable lanes)
        int h0 = (int)(((uint32_t)(row * 2654435761u) + oi * 97u)
                       >> 8) & 127;
        for (int p2 = 0; p2 < nopen && off == 0; ++p2) {
          Chunk& ck = pool_store[open[p2]];
          if (ck.row_published(row)) { ck.cold++; continue; }
          if (rotate) {
            if (!try_rot(ck)) ck.cold++;
            continue;
          }
          int tried = 0;
          int t_max = any_lane ? LANES : 0;
          for (int t = 0; t <= t_max && off == 0; ++t) {
            int jd2 = t == 0 ? jd : (h0 + t - 1) & 127;
            if (t > 0 && jd2 == jd) continue;
            if (ck.depth[jd2] + len > SUBS) continue;
            if (!ck.carrier_free(s_pub, jd2)) continue;
            if (++tried > 16) break;
            try_direct(ck, jd2, s_pub, 0);
          }
          if (off == 0) ck.cold++;
        }
        if (off == 0) {
          if (cell_opened >= cell_budget) {
            spill_rest(0);
            continue;
          }
          // no fit anywhere: take a fresh chunk whole
          Chunk* ckp = open_fresh();
          if (!ckp) return false;
          if (rotate) {
            if (!try_rot(*ckp)) return false;
          } else if (!try_direct(*ckp, jd, s_pub, 0)) {
            return false;
          }
        }
      }

      // ---- aux stream: hub segments, spill_only streams, and any
      // direct remainder.  Prefix placement at rotating lanes.
      int h0 = (int)(((uint32_t)(row * 2654435761u) + oi * 97u) >> 8)
               & 127;
      while (off < len) {
        int rem = len - off;
        int min_pr = rem < 2 ? rem : 2;   // no 1-element dribble: short
        int placed_p = 0;                 // prefixes explode the aux
        for (size_t p = 0; p < open.size() && !placed_p; ++p) {
          Chunk& ck = pool_store[open[p]];
          int tried = 0;
          for (int t = 0; t < LANES && tried < 12; ++t) {
            int jd2 = (h0 + t) & 127;
            if (ck.depth[jd2] > SUBS - min_pr) continue;
            ++tried;
            int nas = 0;
            int pr = ck.route_prefix(segc + off, rem, jd2, as_col,
                                     as_a, as_new, &nas);
            if (pr >= min_pr) {
              int pend = ck.commit(segc + off, segi + off, pr, jd2,
                                   as_col, as_a, as_new, nas);
              ck.aux_pubs.push_back({-1, (int16_t)jd2, (int16_t)pend,
                                     row, 0});
              placed_p = pr;
              break;
            }
          }
        }
        if (!placed_p) {
          if (spill_enable && cell_opened >= cell_budget) {
            spill_rest(off);
            break;
          }
          Chunk* ckp = open_fresh();
          if (!ckp) return false;
          int nas = 0;
          int pr = ckp->route_prefix(segc + off, rem, h0, as_col,
                                     as_a, as_new, &nas);
          if (pr <= 0) return false;
          int pend = ckp->commit(segc + off, segi + off, pr, h0,
                                 as_col, as_a, as_new, nas);
          ckp->aux_pubs.push_back({-1, (int16_t)h0, (int16_t)pend,
                                   row, 0});
          placed_p = pr;
        }
        off += placed_p;
      }
      // retire saturated
      for (int p = (int)open.size() - 1; p >= 0; --p)
        if ((int)pool_store[open[p]].elems.size() >= SLOTS - 8)
          if (!flush_at(p)) return false;
    }
    for (int p = (int)open.size() - 1; p >= 0; --p)
      if (!flush_at(p)) return false;
  }
  return true;
}

}  // namespace

extern "C" int64_t spblas_route2_pack(
    int64_t ne, int64_t ncells, const int64_t* cell_start,
    const int32_t* lrow, const int32_t* lcol, int64_t max_chunks,
    int64_t aux_windows_in, int32_t spill_only,
    int32_t* tiles, int32_t* chunk_cell, int32_t* chunk_auxwin,
    int32_t* chunk_group, int32_t* elem_chunk, int32_t* elem_scat,
    int64_t* aux_info, int64_t* aux_slot, int32_t* aux_lrow,
    int32_t* aux_cell, int32_t* spill_out, int64_t* spill_n,
    int32_t spill_enable, int32_t any_lane, int32_t row_window,
    int32_t rotate, int32_t* chunk_rho) {
  if (row_window < SLOTS || row_window > MAX_ROW_WINDOW
      || (row_window > SLOTS && any_lane)
      || (rotate && any_lane)) return -2;
  int nt = pack_threads_for(ne, ncells);
  std::vector<int64_t> cuts = split_cells(ncells, cell_start, ne, nt);
  std::vector<Out> outs(nt);
  std::vector<AuxAlloc> auxs(nt);
  std::vector<std::vector<AuxPub>> pendings(nt);
  std::vector<std::vector<int32_t>> spills(nt);
  std::vector<uint8_t> ok(nt, 1);
  for (int t = 0; t < nt; ++t) {
    outs[t].elem_chunk = elem_chunk;
    outs[t].elem_scat = elem_scat;
  }
  auto work = [&](int t) {
    ok[t] = pack_cells_range(cell_start, lrow, lcol, cuts[t],
                             cuts[t + 1], spill_only, spill_enable,
                             any_lane, row_window, rotate, outs[t],
                             auxs[t], pendings[t], spills[t]) ? 1 : 0;
  };
  if (nt == 1) {
    work(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(work, t);
    for (auto& th : ths) th.join();
  }
  for (int t = 0; t < nt; ++t)
    if (!ok[t]) return -2;

  // merge in cell order: chunk/group/window/pending/spill offsets
  std::vector<int64_t> choff(nt + 1, 0), goff(nt + 1, 0),
      woff(nt + 1, aux_windows_in), poff(nt + 1, 0), soff(nt + 1, 0);
  for (int t = 0; t < nt; ++t) {
    choff[t + 1] = choff[t] + outs[t].nch;
    goff[t + 1] = goff[t] + outs[t].ngroup;
    woff[t + 1] = woff[t] + (int64_t)auxs[t].windows.size();
    poff[t + 1] = poff[t] + (int64_t)pendings[t].size();
    soff[t + 1] = soff[t] + (int64_t)spills[t].size();
  }
  if (choff[nt] > max_chunks) return -1;  // caller grows and retries
  auto merge_one = [&](int t) {
    Out& o = outs[t];
    std::memcpy(tiles + choff[t] * SLOTS, o.tiles.data(),
                (size_t)o.nch * SLOTS * sizeof(int32_t));
    for (int64_t i = 0; i < o.nch; ++i) {
      chunk_cell[choff[t] + i] = o.chunk_cell[i];
      int32_t aw = o.chunk_auxwin[i];
      chunk_auxwin[choff[t] + i] =
          aw < 0 ? -1 : (int32_t)(woff[t] + aw);
      chunk_group[choff[t] + i] = (int32_t)(goff[t] + o.chunk_group[i]);
      if (chunk_rho) chunk_rho[choff[t] + i] = o.chunk_rho[i];
    }
    if (goff[t]) {
      // group ids were thread-local; spilled entries were zeroed at
      // spill time (spill_rest), so every slot in the range holds a
      // defined value and the blind add cannot overflow
      int64_t e0 = cell_start[cuts[t]], e1 = cell_start[cuts[t + 1]];
      for (int64_t k = e0; k < e1; ++k)
        elem_chunk[k] += (int32_t)goff[t];
    }
    std::vector<AuxPub>& pd = pendings[t];
    for (size_t j = 0; j < pd.size(); ++j) {
      aux_slot[poff[t] + j] = pd[j].abs_slot + woff[t] * SLOTS;
      aux_lrow[poff[t] + j] = pd[j].lrow;
      aux_cell[poff[t] + j] = pd[j].cell;
    }
    if (spill_out)
      for (size_t j = 0; j < spills[t].size(); ++j)
        spill_out[soff[t] + j] = spills[t][j];
  };
  if (nt == 1) {
    merge_one(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(merge_one, t);
    for (auto& th : ths) th.join();
  }
  aux_info[0] = poff[nt];
  aux_info[1] = woff[nt];
  if (spill_n) *spill_n = soff[nt];
  return choff[nt];
}

// ================================================================== //
// ROUTE2-mul packer: dual gather chains (kernels/route2.py
// build_route2_mul_plan / _pack_mul_cell).  Same pool/aux structure as
// the SpMV packer; per element TWO columns (A and B sides) must route
// at the segment's scatter lane.  t1 carries the B chain + the shared
// scatter/reduce/publish fields, t2 the A chain.
// ================================================================== //

namespace {

constexpr int B2_R2 = 0, B2_LF = 8, B2_SD2 = 15;

struct MulSide : EdgeColorHash {
  uint8_t acl[LANES], acj[LANES];

  void reset() {
    std::memset(acl, 0, sizeof acl);
    std::memset(acj, 0, sizeof acj);
    reset_tables();
  }

  // tentative routing of this side's columns at lane jd (all-or-
  // nothing, matching the python _GatherSide.route semantics)
  int route(const int32_t* cols, int len, int jd,
            int32_t* as_col, int8_t* as_a, uint8_t* as_new) {
    int n = 0;
    uint8_t taken_j = 0;
    for (int k = 0; k < len; ++k) {
      int32_t c = cols[k];
      int l = c & 127;
      int64_t ekey = (int64_t)c * 128 + jd;
      if (eh_find(ekey) >= 0) continue;
      bool dup = false;
      for (int t = 0; t < n; ++t)
        if (as_col[t] == c) { dup = true; break; }
      if (dup) continue;
      uint8_t colors = ch_get(c);
      int a_found = -1;
      uint8_t free_j = (uint8_t)~(acj[jd] | taken_j);
      uint8_t reuse = colors & free_j;
      uint8_t isnew = 0;
      if (reuse) {
        a_found = __builtin_ctz(reuse);
      } else {
        uint8_t avail = (uint8_t)(~acl[l]) & free_j;
        if (!avail) return -1;
        a_found = __builtin_ctz(avail);
        isnew = 1;
      }
      taken_j |= (uint8_t)(1 << a_found);
      as_col[n] = c; as_a[n] = (int8_t)a_found; as_new[n] = isnew;
      ++n;
    }
    return n;
  }

  void commit(const int32_t* cols, int len, int jd,
              const int32_t* as_col, const int8_t* as_a,
              const uint8_t* as_new, int nas) {
    for (int t = 0; t < nas; ++t) {
      int32_t c = as_col[t];
      eh_insert((int64_t)c * 128 + jd, as_a[t]);
      acj[jd] |= (uint8_t)(1 << as_a[t]);
      if (as_new[t]) {
        acl[c & 127] |= (uint8_t)(1 << as_a[t]);
        ch_or(c, (uint8_t)(1 << as_a[t]));
      }
    }
    (void)len; (void)cols;
  }

  void emit_into(int32_t* tile, int b_r2, int b_lf) const {
    for (int h = 0; h < EH; ++h) {
      if (eh_key[h] == -1) continue;
      int64_t key = eh_key[h];
      int a = eh_val[h];
      int32_t c = (int32_t)(key >> 7);
      int jd = (int)(key & 127);
      int l = c & 127;
      tile[a * LANES + l] |= (int32_t)((c >> 7) << b_r2);
      tile[a * LANES + jd] |= (int32_t)(l << b_lf);
    }
  }
};

struct MulElem { int32_t ca, cb; int16_t jd; int8_t d, dist; };

struct MulChunk {
  MulSide A, B;
  int8_t depth[LANES];
  uint64_t slots_pub[16];
  std::vector<MulElem> elems;
  std::vector<Pub> pubs;          // slot local, jd, pend
  std::vector<AuxPub> aux_pubs;   // abs_slot filled at flush
  int64_t cold = 0;

  void reset() {
    A.reset(); B.reset();
    std::memset(depth, 0, sizeof depth);
    std::memset(slots_pub, 0, sizeof slots_pub);
    elems.clear(); pubs.clear(); aux_pubs.clear();
    cold = 0;
  }
  bool slot_published(int s) const {
    return (slots_pub[s >> 6] >> (s & 63)) & 1;
  }
  void set_slot_published(int s) {
    slots_pub[s >> 6] |= 1ull << (s & 63);
  }

  // joint tentative route of a segment at lane jd; -1 on failure
  int route(const int32_t* cas, const int32_t* cbs, int len, int jd,
            int32_t* acA, int8_t* aaA, uint8_t* anA, int* nA,
            int32_t* acB, int8_t* aaB, uint8_t* anB, int* nB) {
    if (depth[jd] + len > SUBS) return -1;
    *nA = A.route(cas, len, jd, acA, aaA, anA);
    if (*nA < 0) return -1;
    *nB = B.route(cbs, len, jd, acB, aaB, anB);
    if (*nB < 0) return -1;
    return 0;
  }

  int commit(const int32_t* cas, const int32_t* cbs, int len, int jd,
             const int32_t* acA, const int8_t* aaA, const uint8_t* anA,
             int nA, const int32_t* acB, const int8_t* aaB,
             const uint8_t* anB, int nB) {
    cold = 0;
    A.commit(cas, len, jd, acA, aaA, anA, nA);
    B.commit(cbs, len, jd, acB, aaB, anB, nB);
    int d0 = depth[jd];
    for (int k = 0; k < len; ++k)
      elems.push_back({cas[k], cbs[k], (int16_t)jd, (int8_t)(d0 + k),
                       (int8_t)(k > 7 ? 7 : k)});
    depth[jd] = (int8_t)(d0 + len);
    return d0 + len - 1;
  }
};

// thread-local mul output (merged in cell order; see Out above)
struct MulOut {
  std::vector<int32_t> t1;
  std::vector<int32_t> t2;
  std::vector<int32_t> chunk_cell;
  std::vector<int32_t> chunk_auxwin;
  int64_t nch = 0;

  void grow(std::vector<int32_t>& v) {
    size_t need = (size_t)(nch + 1) * SLOTS;
    if (v.capacity() < need) v.reserve(std::max(need, v.capacity() * 2));
    v.resize(need);
  }
  bool add(int cell, int auxwin, const int32_t* b1, const int32_t* b2) {
    chunk_cell.push_back(cell);
    chunk_auxwin.push_back(auxwin);
    grow(t1); grow(t2);
    std::memcpy(t1.data() + nch * SLOTS, b1, SLOTS * sizeof(int32_t));
    std::memcpy(t2.data() + nch * SLOTS, b2, SLOTS * sizeof(int32_t));
    ++nch;
    return true;
  }
};

bool flush_mul_chunk(MulChunk& ck, int cell, MulOut& out,
                     std::vector<AuxPub>* pending, AuxAlloc* aux) {
  if (ck.elems.empty() && ck.pubs.empty() && ck.aux_pubs.empty())
    return true;
  int32_t b1[SLOTS], b2[SLOTS];
  std::memset(b1, 0, sizeof b1);
  std::memset(b2, 0, sizeof b2);
  ck.B.emit_into(b1, B_R2, B_LF);
  ck.A.emit_into(b2, B2_R2, B2_LF);
  for (const MulElem& e : ck.elems) {
    int aB = ck.B.eh_find((int64_t)e.cb * 128 + e.jd);
    int aA = ck.A.eh_find((int64_t)e.ca * 128 + e.jd);
    b1[e.d * LANES + e.jd] |=
        (int32_t)((aB << B_SD2) | (e.dist << B_DIST));
    b2[e.d * LANES + e.jd] |= (int32_t)(aA << B2_SD2);
  }
  if (!ck.pubs.empty() || ck.aux_pubs.empty()) {
    int32_t d1[SLOTS];
    std::memcpy(d1, b1, sizeof d1);
    for (const Pub& p : ck.pubs)
      d1[p.slot] |= (int32_t)((p.pend << B_PEND) | (1 << B_VA));
    if (!out.add(cell, -1, d1, b2)) return false;
  }
  if (!ck.aux_pubs.empty()) {
    for (AuxPub& p : ck.aux_pubs)
      p.abs_slot = aux->alloc_tail(p.jd);
    std::vector<std::pair<int64_t, const AuxPub*>> bywin;
    for (const AuxPub& p : ck.aux_pubs)
      bywin.push_back({p.abs_slot / SLOTS, &p});
    std::sort(bywin.begin(), bywin.end(),
              [](auto& a, auto& b) { return a.first < b.first; });
    size_t i = 0;
    while (i < bywin.size()) {
      int64_t w = bywin[i].first;
      int32_t d1[SLOTS];
      std::memcpy(d1, b1, sizeof d1);
      for (; i < bywin.size() && bywin[i].first == w; ++i) {
        const AuxPub* p = bywin[i].second;
        int local = (int)(p->abs_slot - w * SLOTS);
        d1[local] |= (int32_t)((p->pend << B_PEND) | (1 << B_VA));
      }
      if (!out.add(cell, (int32_t)w, d1, b2)) return false;
    }
  }
  if (pending)
    for (AuxPub p : ck.aux_pubs) {
      p.cell = cell;
      pending->push_back(p);
    }
  return true;
}

}  // namespace

namespace {

bool pack_mul_cells_range(
    const int64_t* cell_start, const int32_t* lslot, const int32_t* la,
    const int32_t* lb, int64_t c_begin, int64_t c_end,
    MulOut& out, AuxAlloc& aux, std::vector<AuxPub>& pending) {
  std::vector<MulChunk> pool_store(MAX_OPEN + 1);
  for (auto& c : pool_store) c.reset();

  std::vector<int> seg_start, seg_len, seg_slot, seg_order;
  int32_t sega[SUBS], segb[SUBS];
  int32_t acA[SUBS], acB[SUBS];
  int8_t aaA[SUBS], aaB[SUBS];
  uint8_t anA[SUBS], anB[SUBS];

  for (int64_t cell = c_begin; cell < c_end; ++cell) {
    int64_t a0 = cell_start[cell], a1 = cell_start[cell + 1];
    if (a0 >= a1) continue;
    seg_start.clear(); seg_len.clear(); seg_slot.clear();
    {
      int64_t i = a0;
      while (i < a1) {
        int32_t s = lslot[i];
        int64_t j = i;
        while (j < a1 && lslot[j] == s && j - i < SUBS) ++j;
        seg_start.push_back((int)(i - a0));
        seg_len.push_back((int)(j - i));
        seg_slot.push_back(s);
        i = j;
      }
    }
    int nseg = (int)seg_start.size();
    seg_order.resize(nseg);
    for (int s = 0; s < nseg; ++s) seg_order[s] = s;
    std::stable_sort(seg_order.begin(), seg_order.end(),
                     [&](int x, int y) {
                       return seg_len[x] > seg_len[y];
                     });

    std::vector<int> open;
    std::vector<int> freelist;
    for (int i2 = 0; i2 <= MAX_OPEN; ++i2) freelist.push_back(i2);

    auto flush_at = [&](int pos) -> bool {
      int id = open[pos];
      bool ok = flush_mul_chunk(pool_store[id], (int)cell, out,
                                &pending, &aux);
      pool_store[id].reset();
      freelist.push_back(id);
      open.erase(open.begin() + pos);
      return ok;
    };

    for (int oi = 0; oi < nseg; ++oi) {
      int s = seg_order[oi];
      int len = seg_len[s];
      int slot_l = seg_slot[s];
      for (int k = 0; k < len; ++k) {
        sega[k] = la[a0 + seg_start[s] + k];
        segb[k] = lb[a0 + seg_start[s] + k];
      }
      int jd = slot_l & 127;
      bool placed = false;
      int nA = 0, nB = 0;
      for (size_t p = 0; p < open.size(); ++p) {
        MulChunk& ck = pool_store[open[p]];
        if (ck.slot_published(slot_l)) { ck.cold++; continue; }
        if (ck.route(sega, segb, len, jd, acA, aaA, anA, &nA,
                     acB, aaB, anB, &nB) == 0) {
          int pend = ck.commit(sega, segb, len, jd, acA, aaA, anA,
                               nA, acB, aaB, anB, nB);
          ck.pubs.push_back({slot_l, (int16_t)jd, (int16_t)pend});
          ck.set_slot_published(slot_l);
          placed = true;
          break;
        }
        ck.cold++;
      }
      if (!placed && (int)open.size() >= MAX_OPEN) {
        // aux relief at rotating lanes
        int h0 = (int)(((uint32_t)(slot_l * 2654435761u) + oi * 97u)
                       >> 8) & 127;
        for (size_t p = 0; p < open.size() && !placed; ++p) {
          MulChunk& ck = pool_store[open[p]];
          int tried = 0;
          for (int t = 0; t < LANES && tried < 16; ++t) {
            int jd2 = (h0 + t) & 127;
            if (ck.depth[jd2] + len > SUBS) continue;
            ++tried;
            if (ck.route(sega, segb, len, jd2, acA, aaA, anA, &nA,
                         acB, aaB, anB, &nB) == 0) {
              int pend = ck.commit(sega, segb, len, jd2, acA, aaA,
                                   anA, nA, acB, aaB, anB, nB);
              ck.aux_pubs.push_back({-1, (int16_t)jd2, (int16_t)pend,
                                     slot_l, 0});
              placed = true;
              break;
            }
          }
        }
      }
      if (!placed) {
        if ((int)open.size() >= MAX_OPEN) {
          size_t coldest = 0;
          for (size_t p = 1; p < open.size(); ++p)
            if (pool_store[open[p]].cold >
                pool_store[open[coldest]].cold)
              coldest = p;
          if (!flush_at((int)coldest)) return false;
        }
        int id = freelist.back(); freelist.pop_back();
        MulChunk& ck = pool_store[id];
        open.push_back(id);
        if (ck.route(sega, segb, len, jd, acA, aaA, anA, &nA,
                     acB, aaB, anB, &nB) != 0)
          return false;
        int pend = ck.commit(sega, segb, len, jd, acA, aaA, anA, nA,
                             acB, aaB, anB, nB);
        ck.pubs.push_back({slot_l, (int16_t)jd, (int16_t)pend});
        ck.set_slot_published(slot_l);
      }
      for (int p = (int)open.size() - 1; p >= 0; --p)
        if ((int)pool_store[open[p]].elems.size() >= SLOTS - 8)
          if (!flush_at(p)) return false;
    }
    for (int p = (int)open.size() - 1; p >= 0; --p)
      if (!flush_at(p)) return false;
  }
  return true;
}

}  // namespace

extern "C" int64_t spblas_route2_mul_pack(
    int64_t ne, int64_t ncells, const int64_t* cell_start,
    const int32_t* lslot, const int32_t* la, const int32_t* lb,
    int64_t max_chunks, int64_t aux_windows_in,
    int32_t* t1, int32_t* t2, int32_t* chunk_cell,
    int32_t* chunk_auxwin,
    int64_t* aux_info, int64_t* aux_slot, int32_t* aux_lslot,
    int32_t* aux_cell) {
  int nt = pack_threads_for(ne, ncells);
  std::vector<int64_t> cuts = split_cells(ncells, cell_start, ne, nt);
  std::vector<MulOut> outs(nt);
  std::vector<AuxAlloc> auxs(nt);
  std::vector<std::vector<AuxPub>> pendings(nt);
  std::vector<uint8_t> ok(nt, 1);
  auto work = [&](int t) {
    ok[t] = pack_mul_cells_range(cell_start, lslot, la, lb, cuts[t],
                                 cuts[t + 1], outs[t], auxs[t],
                                 pendings[t]) ? 1 : 0;
  };
  if (nt == 1) {
    work(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(work, t);
    for (auto& th : ths) th.join();
  }
  for (int t = 0; t < nt; ++t)
    if (!ok[t]) return -2;

  std::vector<int64_t> choff(nt + 1, 0), woff(nt + 1, aux_windows_in),
      poff(nt + 1, 0);
  for (int t = 0; t < nt; ++t) {
    choff[t + 1] = choff[t] + outs[t].nch;
    woff[t + 1] = woff[t] + (int64_t)auxs[t].windows.size();
    poff[t + 1] = poff[t] + (int64_t)pendings[t].size();
  }
  if (choff[nt] > max_chunks) return -1;
  auto merge_one = [&](int t) {
    MulOut& o = outs[t];
    std::memcpy(t1 + choff[t] * SLOTS, o.t1.data(),
                (size_t)o.nch * SLOTS * sizeof(int32_t));
    std::memcpy(t2 + choff[t] * SLOTS, o.t2.data(),
                (size_t)o.nch * SLOTS * sizeof(int32_t));
    for (int64_t i = 0; i < o.nch; ++i) {
      chunk_cell[choff[t] + i] = o.chunk_cell[i];
      int32_t aw = o.chunk_auxwin[i];
      chunk_auxwin[choff[t] + i] =
          aw < 0 ? -1 : (int32_t)(woff[t] + aw);
    }
    std::vector<AuxPub>& pd = pendings[t];
    for (size_t j = 0; j < pd.size(); ++j) {
      aux_slot[poff[t] + j] = pd[j].abs_slot + woff[t] * SLOTS;
      aux_lslot[poff[t] + j] = pd[j].lrow;
      aux_cell[poff[t] + j] = pd[j].cell;
    }
  };
  if (nt == 1) {
    merge_one(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(merge_one, t);
    for (auto& th : ths) th.join();
  }
  aux_info[0] = poff[nt];
  aux_info[1] = woff[nt];
  return choff[nt];
}
