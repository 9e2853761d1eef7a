// ROUTE chunk packer — native hot loop of kernels/route_plan.py /
// route_mul.py (the two-phase protocol's inspector; reference analogue:
// the vendor optimize handles, e.g. cusparse spmv_impl analysis phase).
//
// The python builder stays as the no-toolchain fallback; this file must
// mirror its packing semantics exactly (tests run the numpy simulator
// against the dense oracle on plans built by either path).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int LANES = 128;
constexpr int SUBS = 8;
constexpr int SLOTS = LANES * SUBS;

// ----------------------------------------------------------------- //
// Euler-split 8-edge-coloring on the 128+128 bipartite multigraph
// ----------------------------------------------------------------- //

struct Colorer {
  // all arrays sized for exactly SLOTS edges
  int32_t color[SLOTS];
  int64_t nxt[2 * SLOTS];
  int64_t head[2 * LANES];
  bool used[SLOTS];
  int32_t su[SLOTS], sl[SLOTS], du[SLOTS], dl[SLOTS];

  void euler_split(const int32_t* ids, int n, int bit) {
    // color bit `bit` of each edge in ids according to an alternating
    // closed-trail walk (all degrees even)
    std::memset(head, -1, sizeof(head));
    for (int k = 0; k < n; ++k) {
      int e = ids[k];
      nxt[2 * k] = head[sl[e]];
      head[sl[e]] = 2 * k;
      nxt[2 * k + 1] = head[LANES + dl[e]];
      head[LANES + dl[e]] = 2 * k + 1;
    }
    for (int k = 0; k < n; ++k) used[k] = false;
    for (int start = 0; start < 2 * LANES; ++start) {
      for (;;) {
        int64_t h = head[start];
        while (h != -1 && used[h >> 1]) h = nxt[h];
        head[start] = h;
        if (h == -1) break;
        int node = start;
        int flag = 0;
        for (;;) {
          int k = (int)(h >> 1);
          int e = ids[k];
          used[k] = true;
          if (flag)
            color[e] |= (1 << bit);
          else
            color[e] &= ~(1 << bit);
          flag ^= 1;
          node = ((h & 1) == 0) ? (LANES + dl[e]) : sl[e];
          if (node == start) break;
          int64_t h2 = head[node];
          while (h2 != -1 && used[h2 >> 1]) h2 = nxt[h2];
          head[node] = h2;
          h = h2;
          if (h == -1) break;  // cannot happen on even-degree graphs
        }
      }
    }
  }

  // 3-phase pull indices for the bijection src[k]->dst[k] over SLOTS
  // slots; writes q1,q2,q3 (each SUBS*LANES ints)
  void route(const int32_t* src, const int32_t* dst, int32_t* q1,
             int32_t* q2, int32_t* q3) {
    for (int e = 0; e < SLOTS; ++e) {
      su[e] = src[e] / LANES;
      sl[e] = src[e] % LANES;
      du[e] = dst[e] / LANES;
      dl[e] = dst[e] % LANES;
      color[e] = 0;
    }
    static thread_local std::vector<int32_t> half_a;
    // 3 levels of euler splitting: bits 2,1,0 of the color
    for (int level = 0; level < 3; ++level) {
      // group edges by the color bits already fixed (above `level`)
      // simple approach: bucket by color>>(3-level)
      int groups = 1 << level;
      for (int gidx = 0; gidx < groups; ++gidx) {
        half_a.clear();
        for (int e = 0; e < SLOTS; ++e)
          if ((color[e] >> (3 - level)) == gidx) half_a.push_back(e);
        euler_split(half_a.data(), (int)half_a.size(), 2 - level);
      }
    }
    for (int e = 0; e < SLOTS; ++e) {
      int c = color[e];
      q1[c * LANES + sl[e]] = su[e];
      q2[c * LANES + dl[e]] = sl[e];
      q3[du[e] * LANES + dl[e]] = c;
    }
  }
};

struct Seg {
  int32_t start, len, row;  // element range + local row (or slot)
  bool first;               // first segment of its row in this cell
};

}  // namespace

extern "C" {

// Pack one matrix's (cell-sorted) element stream into ROUTE chunks.
// Returns nchunks, or -1 if max_chunks is too small.
int64_t spblas_route_pack(
    int64_t ne, int64_t ncells, const int64_t* cell_start,
    const int32_t* lrow, const int32_t* lcol, int64_t max_chunks,
    int32_t* elem_chunk, int32_t* elem_gatpos, int32_t* t1, int32_t* t3,
    int32_t* chunk_cell, int32_t* chunk_auxwin, int64_t* aux_n_out,
    int32_t* aux_slot, int32_t* aux_lrow, int32_t* aux_cell,
    int64_t* aux_count_out) {
  static thread_local Colorer col;
  std::vector<Seg> segs;
  std::vector<int> pool_direct, pool_aux, remaining, leftover, chosen;
  std::vector<int> place_lane, place_off, tgt;
  int64_t nchunks = 0;
  int64_t aux_n = 0;      // allocated aux slots (incl. alignment)
  int64_t aux_cnt = 0;    // emitted aux segments

  int32_t gsrc[SLOTS], gdst[SLOTS];
  int32_t q1[SLOTS], q2[SLOTS], q3[SLOTS];

  for (int64_t cell = 0; cell < ncells; ++cell) {
    int64_t a = cell_start[cell], b = cell_start[cell + 1];
    // segmentation: runs of <=8 per row
    segs.clear();
    for (int64_t i = a; i < b;) {
      int64_t j = i + 1;
      while (j < b && lrow[j] == lrow[i] && j - i < SUBS) ++j;
      bool first = (i == a) || (lrow[i - 1] != lrow[i]);
      segs.push_back({(int32_t)i, (int32_t)(j - i), lrow[i], first});
      i = j;
    }
    pool_direct.clear();
    pool_aux.clear();
    for (int s = 0; s < (int)segs.size(); ++s)
      (segs[s].first ? pool_direct : pool_aux).push_back(s);

    for (int poolid = 0; poolid < 2; ++poolid) {
      bool is_aux = poolid == 1;
      remaining = is_aux ? pool_aux : pool_direct;
      while (!remaining.empty()) {
        int class_cnt[SUBS] = {0};
        int lane_fill[LANES] = {0};
        chosen.clear();
        place_lane.clear();
        place_off.clear();
        leftover.clear();
        for (int s : remaining) {
          const Seg& sg = segs[s];
          int cls[SUBS] = {0};
          bool ok = true;
          for (int e = sg.start; e < sg.start + sg.len; ++e)
            cls[(lcol[e] / LANES) % SUBS]++;
          for (int c2 = 0; c2 < SUBS; ++c2)
            if (class_cnt[c2] + cls[c2] > LANES) ok = false;
          int lane = -1;
          if (ok) {
            for (int l2 = 0; l2 < LANES; ++l2)
              if (lane_fill[l2] + sg.len <= SUBS) {
                lane = l2;
                break;
              }
          }
          if (!ok || lane < 0 ||
              (!is_aux && (int64_t)chosen.size() >= SLOTS)) {
            leftover.push_back(s);
            continue;
          }
          place_lane.push_back(lane);
          place_off.push_back(lane_fill[lane]);
          lane_fill[lane] += sg.len;
          for (int c2 = 0; c2 < SUBS; ++c2) class_cnt[c2] += cls[c2];
          chosen.push_back(s);
        }
        if (chosen.empty()) return -2;  // no progress (invalid input)
        if (nchunks >= max_chunks) return -1;

        // targets
        tgt.clear();
        int32_t auxwin = -1;
        if (is_aux) {
          int64_t start = ((aux_n + LANES - 1) / LANES) * LANES;
          if (start % SLOTS + (int64_t)chosen.size() > SLOTS)
            start = ((start + SLOTS - 1) / SLOTS) * SLOTS;
          int64_t win = (start / SLOTS) * SLOTS;
          auxwin = (int32_t)(win / SLOTS);
          for (size_t k = 0; k < chosen.size(); ++k) {
            tgt.push_back((int32_t)(start - win + k));
            aux_slot[aux_cnt] = (int32_t)(start + k);
            aux_lrow[aux_cnt] = segs[chosen[k]].row;
            aux_cell[aux_cnt] = (int32_t)cell;
            ++aux_cnt;
          }
          aux_n = start + (int64_t)chosen.size();
        } else {
          for (int s : chosen) tgt.push_back(segs[s].row);
        }

        // gather placement + scatter positions
        bool used_g[SLOTS] = {false};
        bool used_s[SLOTS] = {false};
        int class_fill[SUBS] = {0};
        int32_t* T1 = t1 + nchunks * SLOTS;
        int32_t* T3 = t3 + nchunks * SLOTS;
        std::memset(T1, 0, SLOTS * 4);
        std::memset(T3, 0, SLOTS * 4);
        int n_real = 0;
        static thread_local std::vector<int32_t> gposv, sposv;
        gposv.clear();
        sposv.clear();
        for (size_t k = 0; k < chosen.size(); ++k) {
          const Seg& sg = segs[chosen[k]];
          for (int w = 0; w < sg.len; ++w) {
            int e = sg.start + w;
            int xl = lcol[e] % LANES;
            int xs = lcol[e] / LANES;
            int cls = xs % SUBS;
            int gpos = cls * LANES + class_fill[cls]++;
            int spos = (place_off[k] + w) * LANES + place_lane[k];
            elem_chunk[e] = (int32_t)nchunks;
            elem_gatpos[e] = gpos;
            T1[gpos] |= (xl << 3) | ((xs / SUBS) << 10);
            T3[spos] |= w;  // dist
            used_g[gpos] = true;
            used_s[spos] = true;
            gposv.push_back(gpos);
            sposv.push_back(spos);
            ++n_real;
          }
        }
        // permute1: gather -> scatter (pads fill the bijection)
        {
          for (int p = 0; p < n_real; ++p) {
            gsrc[p] = gposv[p];
            gdst[p] = sposv[p];
          }
          int p = n_real;
          for (int q = 0; q < SLOTS; ++q)
            if (!used_g[q]) gsrc[p++] = q;
          p = n_real;
          for (int q = 0; q < SLOTS; ++q)
            if (!used_s[q]) gdst[p++] = q;
          col.route(gsrc, gdst, q1, q2, q3);
          for (int q = 0; q < SLOTS; ++q)
            T1[q] |= (q1[q] << 13) | (q2[q] << 16) | (q3[q] << 23);
        }
        // permute2: segment ends -> targets
        {
          bool used2[SLOTS] = {false};
          bool usedd[SLOTS] = {false};
          int p = 0;
          for (size_t k = 0; k < chosen.size(); ++k) {
            const Seg& sg = segs[chosen[k]];
            int src2 = (place_off[k] + sg.len - 1) * LANES + place_lane[k];
            gsrc[p] = src2;
            gdst[p] = tgt[k];
            used2[src2] = true;
            usedd[tgt[k]] = true;
            ++p;
          }
          for (int q = 0; q < SLOTS; ++q)
            if (!used2[q]) gsrc[p++] = q;
          p = (int)chosen.size();
          for (int q = 0; q < SLOTS; ++q)
            if (!usedd[q]) gdst[p++] = q;
          col.route(gsrc, gdst, q1, q2, q3);
          for (size_t k = 0; k < chosen.size(); ++k)
            T3[tgt[k]] |= (1 << 3);  // vA
          for (int q = 0; q < SLOTS; ++q)
            T3[q] |= (q1[q] << 4) | (q2[q] << 7) | (q3[q] << 14);
        }
        chunk_cell[nchunks] = (int32_t)cell;
        chunk_auxwin[nchunks] = auxwin;
        ++nchunks;
        remaining = leftover;
      }
    }
  }
  *aux_n_out = aux_n;
  *aux_count_out = aux_cnt;
  return nchunks;
}

// Pack the SpGEMM expansion stream (cell-sorted) into ROUTE-mul chunks
// (kernels/route_mul.py hot loop).  lo/la/lb are the window-local slot /
// src_a / src_b per element.  Writes t1/t2/t3 tiles and the owning cell
// per chunk.  Returns nchunks, -1 if max_chunks too small, -2 on invalid
// input (packing stall).
int64_t spblas_route_mul_pack(
    int64_t ne, int64_t ncells, const int64_t* cell_start,
    const int32_t* lo, const int32_t* la, const int32_t* lb,
    int64_t max_chunks, int32_t* t1o, int32_t* t2o, int32_t* t3o,
    int32_t* chunk_cell) {
  static thread_local Colorer col;
  std::vector<Seg> segs;
  std::vector<int> remaining, leftover, chosen, place_lane, place_off;
  // committed per-entry gather placement (sublane, lane-column)
  static thread_local std::vector<int8_t> e_sub, e_col;
  e_sub.resize((size_t)ne);
  e_col.resize((size_t)ne);
  // cols_by_key: key = l_a(7) | oct_a(3)<<7 -> lane-columns carrying that
  // (l_a, oct_a); cleared lazily per chunk via touched_keys.  The last
  // chunk's entries survive the loop, so clear everything on entry.
  static thread_local std::vector<std::vector<int>> cols_by_key;
  if (cols_by_key.size() < 1024) cols_by_key.resize(1024);
  for (auto& cv : cols_by_key) cv.clear();
  std::vector<int> touched_keys;

  int32_t gsrc[SLOTS], gdst[SLOTS];
  int32_t q1[SLOTS], q2[SLOTS], q3[SLOTS];
  int64_t nchunks = 0;

  for (int64_t cell = 0; cell < ncells; ++cell) {
    int64_t a = cell_start[cell], b = cell_start[cell + 1];
    // segments: runs of one slot, <=8 entries
    segs.clear();
    for (int64_t i = a; i < b;) {
      int64_t j = i + 1;
      while (j < b && lo[j] == lo[i] && j - i < SUBS) ++j;
      segs.push_back({(int32_t)i, (int32_t)(j - i), lo[i], false});
      i = j;
    }
    remaining.clear();
    for (int s = 0; s < (int)segs.size(); ++s) remaining.push_back(s);

    while (!remaining.empty()) {
      int lane_fill[LANES] = {0};
      bool slot_used[SLOTS] = {false};
      uint8_t occ[LANES] = {0};
      int next_col = 0;
      for (int k : touched_keys) cols_by_key[k].clear();
      touched_keys.clear();
      chosen.clear();
      place_lane.clear();
      place_off.clear();
      leftover.clear();
      for (int s : remaining) {
        const Seg& sg = segs[s];
        // one segment per output slot per chunk (permute2 targets must
        // be distinct)
        if (slot_used[sg.row]) {
          leftover.push_back(s);
          continue;
        }
        // scatter stack first-fit (state-free check, so do it first)
        int lane = -1;
        for (int l2 = 0; l2 < LANES; ++l2)
          if (lane_fill[l2] + sg.len <= SUBS) {
            lane = l2;
            break;
          }
        if (lane < 0) {
          leftover.push_back(s);
          continue;
        }
        // gather placement, tentatively (undo on overflow): each entry
        // needs a lane-column dedicated to its (l_a, oct_a) with its
        // s7_b sublane free
        int u_col[SUBS], u_sub[SUBS], u_key[SUBS];
        int n_undo = 0, n_new = 0;
        bool good = true;
        for (int e = sg.start; e < sg.start + sg.len; ++e) {
          int key = (la[e] % LANES) | (((la[e] / LANES) / SUBS) << 7);
          int sub = (lb[e] / LANES) % SUBS;
          int c2 = -1;
          for (int cc : cols_by_key[key])
            if (!((occ[cc] >> sub) & 1)) {
              c2 = cc;
              break;
            }
          if (c2 < 0) {
            if (next_col >= LANES) {
              good = false;
              break;
            }
            c2 = next_col++;
            if (cols_by_key[key].empty()) touched_keys.push_back(key);
            cols_by_key[key].push_back(c2);
            u_key[n_new++] = key;
          }
          occ[c2] |= (uint8_t)(1 << sub);
          u_col[n_undo] = c2;
          u_sub[n_undo] = sub;
          ++n_undo;
          e_sub[e] = (int8_t)sub;
          e_col[e] = (int8_t)c2;
        }
        if (!good) {
          for (int k2 = 0; k2 < n_undo; ++k2)
            occ[u_col[k2]] &= (uint8_t)~(1 << u_sub[k2]);
          for (int k2 = n_new - 1; k2 >= 0; --k2) {
            cols_by_key[u_key[k2]].pop_back();
            --next_col;
          }
          leftover.push_back(s);
          continue;
        }
        place_lane.push_back(lane);
        place_off.push_back(lane_fill[lane]);
        lane_fill[lane] += sg.len;
        slot_used[sg.row] = true;
        chosen.push_back(s);
      }
      if (chosen.empty()) return -2;
      if (nchunks >= max_chunks) return -1;

      int32_t* T1 = t1o + nchunks * SLOTS;
      int32_t* T2 = t2o + nchunks * SLOTS;
      int32_t* T3 = t3o + nchunks * SLOTS;
      std::memset(T1, 0, SLOTS * 4);
      std::memset(T2, 0, SLOTS * 4);
      std::memset(T3, 0, SLOTS * 4);
      int32_t col_la[LANES] = {0}, col_oa[LANES] = {0};
      bool used_g[SLOTS] = {false};
      bool used_s[SLOTS] = {false};
      static thread_local std::vector<int32_t> gposv, sposv;
      gposv.clear();
      sposv.clear();
      for (size_t k = 0; k < chosen.size(); ++k) {
        const Seg& sg = segs[chosen[k]];
        for (int w = 0; w < sg.len; ++w) {
          int e = sg.start + w;
          int sub = e_sub[e], c2 = e_col[e];
          int gpos = sub * LANES + c2;
          int spos = (place_off[k] + w) * LANES + place_lane[k];
          T1[gpos] |= (lb[e] % LANES) | (((lb[e] / LANES) / SUBS) << 7);
          T2[gpos] = (la[e] % LANES) | (((la[e] / LANES) / SUBS) << 7)
                     | (((la[e] / LANES) % SUBS) << 10);
          col_la[c2] = la[e] % LANES;
          col_oa[c2] = (la[e] / LANES) / SUBS;
          T3[spos] |= w;  // dist
          used_g[gpos] = true;
          used_s[spos] = true;
          gposv.push_back(gpos);
          sposv.push_back(spos);
        }
      }
      // pad gather slots read (l_a, oct_a) at whatever sublane their
      // s7_a field (0) points to — broadcast the column constants down
      for (int p = 0; p < SLOTS; ++p)
        if (T2[p] == 0)
          T2[p] = col_la[p % LANES] | (col_oa[p % LANES] << 7);
      // permute1: gather -> scatter
      {
        int n_real = (int)gposv.size();
        for (int p = 0; p < n_real; ++p) {
          gsrc[p] = gposv[p];
          gdst[p] = sposv[p];
        }
        int p = n_real;
        for (int q = 0; q < SLOTS; ++q)
          if (!used_g[q]) gsrc[p++] = q;
        p = n_real;
        for (int q = 0; q < SLOTS; ++q)
          if (!used_s[q]) gdst[p++] = q;
        col.route(gsrc, gdst, q1, q2, q3);
        for (int q = 0; q < SLOTS; ++q)
          T1[q] |= (q1[q] << 13) | (q2[q] << 16) | (q3[q] << 23);
      }
      // permute2: segment ends -> window-local output slots
      {
        bool used2[SLOTS] = {false};
        bool usedd[SLOTS] = {false};
        int p = 0;
        for (size_t k = 0; k < chosen.size(); ++k) {
          const Seg& sg = segs[chosen[k]];
          int src2 = (place_off[k] + sg.len - 1) * LANES + place_lane[k];
          gsrc[p] = src2;
          gdst[p] = sg.row;
          used2[src2] = true;
          usedd[sg.row] = true;
          ++p;
        }
        for (int q = 0; q < SLOTS; ++q)
          if (!used2[q]) gsrc[p++] = q;
        p = (int)chosen.size();
        for (int q = 0; q < SLOTS; ++q)
          if (!usedd[q]) gdst[p++] = q;
        col.route(gsrc, gdst, q1, q2, q3);
        for (size_t k = 0; k < chosen.size(); ++k)
          T3[segs[chosen[k]].row] |= (1 << 3);  // vA
        for (int q = 0; q < SLOTS; ++q)
          T3[q] |= (q1[q] << 4) | (q2[q] << 7) | (q3[q] << 14);
      }
      chunk_cell[nchunks] = (int32_t)cell;
      ++nchunks;
      remaining = leftover;
    }
  }
  return nchunks;
}

}  // extern "C"
