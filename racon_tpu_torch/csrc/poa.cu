// Batched POA window consensus, the ls tier (poa_kernel="ls"): one thread
// block per window.
//
// Replaces the JAX package's lane-lockstep Pallas kernel
// build_lockstep_poa_kernel (racon_tpu/ops/poa_pallas_ls.py:64, its
// pallas_call at :876), flat and banded. It computes what the plain version
// ops/poa.py:poa_batch_plain(kernel="ls") computes, bit for bit: graph init,
// per-layer global sequence-to-graph DP, a traceback that takes, at every
// cell, the move the plain version re-derives from H, the graph update with
// float32 fractional column keys, and heaviest-bundle consensus with node
// coverage.
//
// What bounds it on an H100: one window's serial chain. A launch holds at
// most 256 windows, two blocks an SM, and lasts as long as its slowest
// window's chain; neither bytes nor integer throughput come near their
// limits. Before this design (a global H read and written by every DP
// row behind two barriers, the in-edges in global memory, a traceback
// with a global round trip a step, a search over every node for each
// matched position, an O(n^2) rank sort a layer) its clock64() phase
// counts put the slowest window of the main path's depth-200 launch at 60%
// DP rows, 27% graph update (the per-position search), 12% traceback and
// 2% rank sort (NVIDIA H100 80GB HBM3, 700 W; PERF.md). A DP row lasts
// about as long as its threads' dependent instructions take in turn: two
// blocks an SM leave too few warps to hide them. So the design takes global
// round trips, barriers, searches and instructions off the chain:
//   * The graph lives on chip: the in-edge sources (int16, N x ES with ES =
//     max_edges rounded up to 4), keys, bases (uint8), rank order, rank_of,
//     the consensus path and the node coverage are in dynamic shared
//     memory; only H, the move records and the edge weights are in the
//     window's global scratch (the weights grow by fire-and-forget atomics).
//   * One block barrier a DP row. The row before in rank order stays in the
//     registers of the threads that own its columns; the cell left of a
//     thread's first column is that row's running max there, which is the
//     thread's own exclusive scan value, so no thread reads another's cell
//     of the row just finished. Older rows come from a shared ring of the
//     last RING rows keyed by rank, or from the global H where a later row
//     reads them from there (marked before the DP); the scan's warp totals
//     alternate between two buffers. A thread's sequence codes are loaded
//     once a layer.
//   * A descriptor a row. Before the layer's DP, one thread a rank lists the
//     row's computed in-subgraph predecessors (rank distance and slot, up
//     to three, in slot order) and its flags in 64 bits, and marks has_out
//     and the rows read from the global H; the row then reads its
//     descriptor instead of decoding and testing its in-edge slots (a row
//     with more predecessors, rare, reads the slots).
//   * Move records. Beside each cell the DP writes one byte, move | slot
//     << 2 (0 diagonal, 1 up, 2 left, 3 re-derive; slot VSLOT the virtual
//     start row): exactly the move the ls traceback re-derives from H. A
//     cell inside the band (every cell of the flat build) is at least its
//     best predecessor plus the move's score, so a diagonal (up) explains it
//     exactly where it equals the largest computed predecessor value plus
//     the score (gap), through the first slot that attains it. A cell the
//     band masks to NEG any slot may explain, by a value of NEG less the
//     score (gap); only a value that near NEG can, and such values are rare
//     (rows the band starved), so a thread that reads one re-reads its
//     predecessors for the first slot that explains each of its masked
//     cells, and every other masked cell records left. A row that reads a
//     predecessor not computed yet (float32 keys equal along an edge: the
//     DP counts it as a row of NEG, the walk reads its finished row)
//     records "re-derive", and then every row of the layer goes to the
//     global H for the walk.
//   * The walk (warp 0) fetches, in one trip to memory, the record of its
//     cell and that of every cell one move away, a byte a lane: two steps a
//     trip.
//   * The rank order is kept, not rebuilt. The update freezes it; each
//     position's matched node is found by binary search over it, one thread
//     a position; the serial pass (warp 0) only numbers new nodes and adds
//     edges, searching this layer's new nodes where a matched key has no
//     old node of the base; one block-wide pass then merges the new nodes
//     into the order by (key, id), which is where inserting each after every
//     key <= its own puts it, since new ids are larger than old ones.
//   * End-node selection is fused into the DP (end scores by rank); the
//     consensus is csrc/poa_common.cuh's.
// Shared memory is about 107 KB at N=1536, max_len=768 and 12 edge slots
// (the traceback's and the update's arrays reuse the ring's bytes), so two
// blocks fit an SM. The graph grows with the window, so each launch
// plans its shared memory against the card's limit a block (plan): the ring
// holds 8, 4 or 2 rows, the largest that fits, and where even 2 do not the
// in-edge sources move to the global scratch (the GSRC instantiation).
// A thread owns up to CHMAX = 8 columns (max_len + 1 <= 2048). Larger
// windows (max_len + 1 <= 4096, up to backbone class 2048) run the wide
// instantiation (CX = CHWIDE = 16 columns a thread, sources in the global
// scratch, up to 255 registers and one block an SM, which is all their
// shared memory allows anyway), so its registers do not weigh on the usual
// build.
// There is no rank-distance cap: a predecessor beyond the ring is read from
// the global H, never refused.
//
// The global build (CX = CHGLOBAL). From backbone class 2176 up (N 6528)
// the graph does not fit a block's shared memory even with a ring of 2 rows
// and the in-edge sources in global memory, so plan picks, by geometry and
// before the launch, a third build: the graph, the rank order, the row
// descriptors and the traceback's and update's per-position arrays move to
// the window's global scratch (carve_global; poa_common::graph_layout), and
// shared memory keeps only the phase cycles, the reductions, the scan's
// warp totals and misc. Each DP row runs in tiles of TW = NT x CHMAX
// columns (dp_layer_tiled), the scan's running max carried from tile to
// tile, one barrier a tile, so max_len has no limit; every row goes to the
// global H and every predecessor row is read from there (L1 and L2 hold the
// recent ones), since a row of 16,384 columns does not fit the registers.
// The cells, records, walk, update and consensus are the other builds',
// bit for bit. Node ids stay int16 up to N = 32,767 (backbone class
// 10,880); above it the global build takes int32 ids (IdT), the one
// build whose graph lives in global memory, so the wider arrays cost
// scratch bytes and leave every other build's registers and shared bytes
// as they are.
//
// The banded build (template BAND; the wrapper's wband argument) replaces
// the Pallas kernel's band=True build: a per-window half band wband in, a
// band hit out, and the ls build's banded semantics. Under wband > 0 column
// 0's diagonal is NEG + mismatch (the Pallas kernel's shifted-in NEG), and
// after its gap pass each DP row is masked to NEG outside |j - cexp| <=
// wband (cexp: the node's key + 0.5, truncated, less the layer's begin).
// The walk is the ls build's (the plain _walk_ls): at each node it goes
// left to the first cell a diagonal (column 0's included) or an up move
// explains, through the first such slot; it fails where a node has no such
// cell (stuck) and where a diagonal leaves column 0 into a node; it ends
// on the virtual row. The records give exactly its choice at every cell,
// in band and masked, as above. The hit is set where the best end score's
// deficit below match x L passes 2 |gap| max(wband / 2, 1), and where the
// walk leaves a node whose visited cells came within one cell of the band
// edge. Rule 1: an end score no better than NEG fails the layer. Rule 2: a
// layer that fails, there or in the walk, adds nothing to the graph. Every
// column is still computed; wband = 0 runs the flat code through the same
// build.
//
// Float discipline: keys are float32 in the plain version's order of
// operations; the library is built with --fmad=false and IEEE division.
// Thread 0 of each block counts clock64() cycles per phase (NPHASE) for the
// optional phases output.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "poa_common.cuh"

#define VSLOT 63       // record slot of the virtual start row; E <= 32
#define NOSLOT 64      // no slot explains the (masked) cell
#define MV_DIAG 0
#define MV_UP 1
#define MV_LEFT 2
#define MV_REDERIVE 3  // a row that read an uncomputed predecessor
#define NPHASE 7       // init, DP, end pick, traceback, update, order,
                       // consensus
#define RING 8         // most DP rows of H kept in shared memory, by rank
#define NONE_ (NEG_ - 1024)  // below every value of H: no predecessor yet
// A DP row's descriptor (Shared::desc), built before the layer's DP: bits
// 0-1 the number of computed in-subgraph predecessors listed, then flags,
// the first in-subgraph slot (6 bits) and up to three entries of 17 bits,
// rank distance (12 bits) | slot << 12, in slot order.
#define D_SLOW 4ull     // more than three, or one 4096 ranks back or more:
                        // the DP reads the in-edge slots
#define D_ANY 8ull      // some in-edge source is in the subgraph
#define D_STALE 16ull   // some in-subgraph source ranks at or after the row
#define D_FIRST 5
#define D_ENT 11

namespace {

using poa_common::better;
using poa_common::block_best;
using poa_common::align16;
using poa_common::count_keys;
using poa_common::edge_stride;
using poa_common::find_new;
using poa_common::find_old;
using poa_common::merge_new;
using poa_common::scratch_layout;
using poa_common::wide_build;
using poa_common::wide_ids;

struct Cfg {
  int N, ML, MB, E, ES, D, ma, mm, gp;
  int ring;  // DP rows in the shared ring: 8, 4 or 2
};

// Node ids (src, order, rank_of, path, found) are IdT: int16 in every
// build but the global build above INT16_NODES node slots (int32).
template <typename IdT>
struct ShT {
  using Id = IdT;
  long long* ph;     // [NPHASE] thread 0's cycles per phase
  unsigned long long* desc;  // [N] by rank: the DP row's descriptor (D_*)
  int* ring;         // [ring][ML + 1] the last DP rows, slot rank % ring
                     // (the DP); shares its bytes with nkey, runrem, wts
                     // and found (traceback and update)
  float* nkey;       // [ML] next matched key at j' >= j (traceback)
  int* runrem;       // [ML] remaining insertion run; 0 marks a match
  int* wts;          // [ML]
  float* key;        // [N] column key by node id
  int* esc;          // [N] end score by rank (layers); score (consensus)
  int* cov;          // [N] node coverage
  int* red_v;        // [NWARP] reduction scratch
  int* red_i;        // [NWARP]
  int* red_w;        // [NWARP]
  int* scan;         // [2][NWARP] the DP rows' warp totals, by row parity
  int* misc;         // [8]: n, failed, r_lo, r_hi, path count, band cells
                     // of the layer, band hit
  int* left;         // [n_tiles][NT] (global build): the row just
                     // finished at the cell left of each thread's first
                     // column of each tile
  IdT* src;          // [N][ES] in-edge sources by slot, -1 empty (shared
                     // memory, or the global scratch with GSRC)
  IdT* order;        // [N] node id by rank; [0, n) sorted by (key, id)
  IdT* rank_of;      // [N] rank by node id (layers); pred (consensus)
  IdT* path;         // [N] consensus path; the merged order (update)
  IdT* found;        // [ML] each position's matched old node, or -1
                     // (in the ring's bytes)
  uint8_t* base;     // [N]
  uint8_t* seq;      // [ML]
  uint8_t* has_out;  // [N] node has an out-edge inside the subgraph
  uint8_t* far;      // [N] by rank: a later row reads this row of H from
                     // the global scratch (not from the ring)
};
using Shared = ShT<int16_t>;  // the shared-memory builds'

// The carve below, as byte offsets, for a ring of `ring` rows and the
// in-edge sources in shared memory unless gsrc; returns the total.
__host__ __device__ inline size_t shared_layout(int N, int ML, int ES,
                                                int ring, bool gsrc,
                                                size_t* off) {
  size_t p = 0;
  off[0] = p; p += NPHASE * 8 + (size_t)N * 8;
  off[1] = p; p += max((size_t)ring * (ML + 1) * 4, (size_t)ML * (4 * 3 + 2));
  off[2] = p = align16(p); p += (size_t)N * 4 * 3 + NWARP * 4 * 5 + 8 * 4;
  off[3] = p = align16(p); p += (gsrc ? 0 : (size_t)N * ES * 2) +
                                (size_t)N * 2 * 3;
  off[4] = p; p += (size_t)N * 3 + ML;
  return align16(p);
}

__host__ __device__ inline size_t shared_bytes(int N, int ML, int ES,
                                               int ring, bool gsrc) {
  size_t off[5];
  return shared_layout(N, ML, ES, ring, gsrc, off);
}

// gsrc: the in-edge sources' global home, or null to carve them here.
__device__ inline Shared carve(char* base, int N, int ML, int ES, int ring,
                               int16_t* gsrc) {
  size_t off[5];
  shared_layout(N, ML, ES, ring, gsrc != nullptr, off);
  Shared s;
  s.ph = (long long*)(base + off[0]);
  s.desc = (unsigned long long*)(base + off[0] + NPHASE * 8);
  char* p = base + off[1];
  s.ring = (int*)p;
  s.nkey = (float*)p; p += ML * 4;
  s.runrem = (int*)p; p += ML * 4;
  s.wts = (int*)p; p += ML * 4;
  s.found = (int16_t*)p;
  p = base + off[2];
  s.key = (float*)p; p += N * 4;
  s.esc = (int*)p; p += N * 4;
  s.cov = (int*)p; p += N * 4;
  s.red_v = (int*)p; p += NWARP * 4;
  s.red_i = (int*)p; p += NWARP * 4;
  s.red_w = (int*)p; p += NWARP * 4;
  s.scan = (int*)p; p += NWARP * 4 * 2;
  s.misc = (int*)p;
  p = base + off[3];
  if (gsrc) {
    s.src = gsrc;
  } else {
    s.src = (int16_t*)p; p += (size_t)N * ES * 2;
  }
  s.order = (int16_t*)p; p += N * 2;
  s.rank_of = (int16_t*)p; p += N * 2;
  s.path = (int16_t*)p;
  p = base + off[4];
  s.base = (uint8_t*)p; p += N;
  s.seq = (uint8_t*)p; p += ML;
  s.has_out = (uint8_t*)p; p += N;
  s.far = (uint8_t*)p;
  s.left = nullptr;
  return s;
}

// The global build's carve: the phase cycles, reductions, scan buffers and
// misc in shared memory (GLOBAL_SHARED bytes), everything else in the
// window's global scratch (poa_common::carve_graph).
template <typename IdT>
__device__ inline ShT<IdT> carve_global(char* base, char* g, int N, int ML,
                                        IdT* gsrc) {
  ShT<IdT> s;
  char* p = base;
  s.ph = (long long*)p; p += NPHASE * 8;
  s.red_v = (int*)p; p += NWARP * 4;
  s.red_i = (int*)p; p += NWARP * 4;
  s.red_w = (int*)p; p += NWARP * 4;
  s.scan = (int*)p; p += NWARP * 4 * 2;
  s.misc = (int*)p;
  poa_common::carve_graph(s, g, N, ML, gsrc);
  return s;
}

struct Win {
  int* H;       // [N + 1][ML + 1]
  int* ew;      // [N][ES] in-edge weights
  uint8_t* MV;  // [N + 1][ML + 1] move records
};

// One layer's DP: every row of ranks [r_lo, r_hi) in rank order, its cells,
// move records and end score, by the whole block, one barrier a row. Each
// thread owns columns [tid * CH, tid * CH + CH) of every row; CHM >= CH is
// how many it unrolls. all_global: every row goes to the global H too (the
// walk re-derives some moves from H). BAND with hw > 0: column 0's diagonal
// is NEG + mismatch and the row is masked to |j - cexp| <= hw after its gap
// pass.
template <int CHM, bool BAND>
__device__ __forceinline__ void dp_layer(const Shared& s, const Cfg& c,
                                         const Win& w, int r_lo, int r_hi,
                                         int L, int CH, bool all_global,
                                         int hw, int begin) {
  const int HS = c.ML + 1, gp = c.gp;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const bool banded = BAND && hw > 0;
  const int j0 = tid * CH;
  int jc[CHM + 1];  // the predecessor columns this thread reads, clamped
#pragma unroll
  for (int k = 0; k <= CHM; ++k) jc[k] = min(max(j0 - 1 + k, 0), L);
  int code[CHM];    // the layer's base at column j - 1 of each own column j
#pragma unroll
  for (int k = 0; k < CHM; ++k) {
    const int j = j0 + k;
    code[k] = k < CH && j >= 1 && j <= L ? s.seq[j - 1] : 0xff;
  }
  int prow[CHM];    // the row just finished, at the thread's columns
  int pleft = NEG_; // and at column j0 - 1
#pragma unroll
  for (int k = 0; k < CHM; ++k) prow[k] = NEG_;
  int par = 0;      // the row's half of the scan's double buffer
  // a predecessor value explains a masked cell (NEG) where it is NEG less
  // a score or the gap: within nwin of NEG, and NEG itself only where a
  // score or the gap is 0
  const int nwin = max(max(abs(c.ma), abs(c.mm)), abs(gp));
  const bool zero = c.ma == 0 || c.mm == 0 || gp == 0;
  for (int r = r_lo; r < r_hi; ++r) {
    const int u = s.order[r];
    const int ub = s.base[u];
    const int cexp = BAND ? (int)(s.key[u] + 0.5f) - begin : 0;
    int sc[CHM];
#pragma unroll
    for (int k = 0; k < CHM; ++k) sc[k] = code[k] == ub ? c.ma : c.mm;
    // one predecessor row at the thread's columns jc (a uniform branch):
    // the row just finished from registers, a near one from the ring, else
    // the global H (sv < 0: the node is order[rk])
    auto pred_row = [&](int sv, int rk, int* v) {
      const int d = r - rk;
      if (d == 1) {
        v[0] = j0 == 0 ? prow[0] : pleft;
#pragma unroll
        for (int k = 1; k <= CHM; ++k) v[k] = prow[k - 1];
      } else if (d < c.ring) {
        const int* rr = s.ring + (rk & (c.ring - 1)) * HS;
#pragma unroll
        for (int k = 0; k <= CHM; ++k) v[k] = rr[jc[k]];
      } else {
        const int node = sv >= 0 ? sv : s.order[rk];
        const int* hr = w.H + (size_t)(node + 1) * HS;
#pragma unroll
        for (int k = 0; k <= CHM; ++k) v[k] = hr[jc[k]];
      }
    };
    // per predecessor column: the largest value over the computed
    // in-subgraph predecessors and the first slot that attains it (M, S)
    int M[CHM + 1], S[CHM + 1];
#pragma unroll
    for (int k = 0; k <= CHM; ++k) {
      M[k] = NONE_;
      S[k] = VSLOT;
    }
    const unsigned long long dsc = s.desc[r];
    const bool any = dsc & D_ANY, stale = dsc & D_STALE;
    const int first = (int)(dsc >> D_FIRST) & 63;
    bool near = false;  // BAND: some predecessor value may explain a
                        // masked cell (nwin)
    auto take = [&](int sv, int rk, int slot) {
      int v[CHM + 1];
      pred_row(sv, rk, v);
#pragma unroll
      for (int k = 0; k <= CHM; ++k) {
        if (v[k] > M[k]) { M[k] = v[k]; S[k] = slot; }
        if (BAND)
          near |= (zero || v[k] != NEG_) &&
                  (unsigned)(v[k] - (NEG_ - nwin)) <= 2u * nwin;
      }
    };
    if (!(dsc & D_SLOW)) {  // the computed predecessors, in slot order
      const int np = (int)(dsc & 3);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (i < np) {
          const int ent = (int)(dsc >> (D_ENT + 17 * i)) & 0x1ffff;
          take(-1, r - (ent & 0xfff), ent >> 12);
        }
      }
    } else {  // from the in-edge slots
      for (int e = 0; e < c.E; ++e) {
        const int sv = s.src[(size_t)u * c.ES + e];
        if (sv < 0) break;
        const int rk = s.rank_of[sv];
        if (rk >= r_lo && rk < r) take(sv, rk, e);
      }
    }
    int P[CHM + 1];
    if (!any) {  // the virtual start row is the only predecessor
#pragma unroll
      for (int k = 0; k <= CHM; ++k) {
        P[k] = M[k] = (j0 - 1 + k) * gp;
        if (BAND)
          near |= (zero || P[k] != NEG_) &&
                  (unsigned)(P[k] - (NEG_ - nwin)) <= 2u * nwin;
      }
    } else {
#pragma unroll
      for (int k = 0; k <= CHM; ++k) P[k] = max(M[k], NEG_);
    }
    // BAND, where a predecessor value lies near NEG (rare, per thread): the
    // record of each own cell if the band masks it, from the first slot
    // whose value is NEG less the score (a diagonal) or the gap (up), as
    // bytes of offrec; otherwise a masked cell is left
    int offrec[(CHM + 3) / 4];
#pragma unroll
    for (int q = 0; q < (CHM + 3) / 4; ++q) offrec[q] = MV_LEFT * 0x01010101;
    if (BAND && near) {
      int dq[CHM], uq[CHM];
#pragma unroll
      for (int k = 0; k < CHM; ++k) {
        dq[k] = !any && P[k] == NEG_ - sc[k] ? VSLOT : NOSLOT;
        uq[k] = !any && P[k + 1] == NEG_ - gp ? VSLOT : NOSLOT;
      }
      for (int e = 0; any && e < c.E; ++e) {
        const int sv = s.src[(size_t)u * c.ES + e];
        if (sv < 0) break;
        const int rk = s.rank_of[sv];
        if (rk < r_lo || rk >= r) continue;
        int v[CHM + 1];
        pred_row(sv, rk, v);
#pragma unroll
        for (int k = 0; k < CHM; ++k) {
          if (dq[k] == NOSLOT && v[k] == NEG_ - sc[k]) dq[k] = e;
          if (uq[k] == NOSLOT && v[k + 1] == NEG_ - gp) uq[k] = e;
        }
      }
#pragma unroll
      for (int k = 0; k < CHM; ++k) {
        const int mv = j0 + k >= 1 && dq[k] != NOSLOT ? MV_DIAG | dq[k] << 2
                       : uq[k] != NOSLOT              ? MV_UP | uq[k] << 2
                                                      : MV_LEFT;
        offrec[k >> 2] ^= (mv ^ MV_LEFT) << (8 * (k & 3));
      }
    }
    int x[CHM];
    int run = INT_MIN;
#pragma unroll
    for (int k = 0; k < CHM; ++k) {
      const int j = j0 + k;
      int v = INT_MIN;
      if (k < CH && j <= L) {
        v = P[k + 1] + gp;
        if (j >= 1)
          v = max(v, P[k] + sc[k]);
        else if (banded)
          v = max(v, NEG_ + c.mm);
        v -= j * gp;
      }
      run = max(run, v);
      x[k] = run;
    }
    // the block's inclusive max-scan of the thread totals
    int tot = run;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, tot, d);
      if (lane >= d) tot = max(tot, o);
    }
    int* scan = s.scan + par * NWARP;
    par ^= 1;
    if (lane == 31) scan[wid] = tot;
    int excl = __shfl_up_sync(0xffffffffu, tot, 1);
    if (lane == 0) excl = INT_MIN;
    __syncthreads();
    for (int q = 0; q < wid; ++q) excl = max(excl, scan[q]);
    int* hrow = w.H + (size_t)(u + 1) * HS;
    const bool global = all_global || s.far[r];
    int* rrow = s.ring + (size_t)(r & (c.ring - 1)) * HS;
    uint8_t* mrow = w.MV + (size_t)(u + 1) * HS;
#pragma unroll
    for (int k = 0; k < CHM; ++k) {
      const int j = j0 + k;
      if (k < CH && j <= L) {
        int row = max(x[k], excl) + j * gp;
        const bool off = banded && abs(j - cexp) > hw;
        if (off) row = NEG_;
        prow[k] = row;
        if (global) hrow[j] = row;
        rrow[j] = row;
        int mv = MV_LEFT;
        if (stale) {
          mv = MV_REDERIVE;
        } else if (banded && j == 0 && row == NEG_ + c.mm) {
          mv = MV_DIAG | first << 2;
        } else if (off) {
          mv = (offrec[k >> 2] >> (8 * (k & 3))) & 0xff;
        } else if (j >= 1 && row == M[k] + sc[k]) {
          mv = MV_DIAG | S[k] << 2;
        } else if (row == M[k + 1] + gp) {
          mv = MV_UP | S[k + 1] << 2;
        }
        mrow[j] = (uint8_t)mv;
        if (j == L) s.esc[r] = row;
      }
    }
    // column j0 - 1 of this row: its running max there, this thread's
    // exclusive scan value (thread 0 reads its own column 0 instead)
    if (j0 >= 1)
      pleft = banded && abs(j0 - 1 - cexp) > hw ? NEG_
                                                : excl + (j0 - 1) * gp;
  }
  __syncthreads();
}

// dp_layer with the thread's columns unrolled to the next of 2, 4, 8 (and
// in the wide build, CX = CHWIDE, 16) at or above CH (a uniform branch).
template <int CX, bool BAND>
__device__ __forceinline__ void dp_layer_ch(const Shared& s, const Cfg& c,
                                            const Win& w, int r_lo, int r_hi,
                                            int L, bool all_global, int hw,
                                            int begin) {
  const int CH = (L + 1 + NT - 1) / NT;
  if (CH <= 2)
    dp_layer<2, BAND>(s, c, w, r_lo, r_hi, L, CH, all_global, hw, begin);
  else if (CH <= 4)
    dp_layer<4, BAND>(s, c, w, r_lo, r_hi, L, CH, all_global, hw, begin);
  else if (CX == CHMAX || CH <= CHMAX)
    dp_layer<CHMAX, BAND>(s, c, w, r_lo, r_hi, L, CH, all_global, hw,
                          begin);
  else
    dp_layer<CX, BAND>(s, c, w, r_lo, r_hi, L, CH, all_global, hw, begin);
}

// The global build's layer DP: dp_layer's rows, cells, move records and
// end scores, with each row's columns [0, L] in tiles of TW (tile t,
// thread tid: columns t * TW + tid * CHMAX + k), so max_len has no limit.
// A tile's scan starts from the running max of the tiles before it
// (carry); one barrier a tile, the warp totals alternating between two
// buffers. Every row goes to the global H, and every predecessor row is
// read from there: a thread's own columns of the row just finished are
// cells it wrote itself, and the cell left of its first column is that
// row's running max there, which it kept in left[t][tid] (masked as the
// row was).
template <bool BAND, class Sh>
__device__ void dp_layer_tiled(const Sh& s, const Cfg& c, const Win& w,
                               int r_lo, int r_hi, int L, int hw,
                               int begin) {
  constexpr int CHM = CHMAX;
  const int HS = c.ML + 1, gp = c.gp;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const bool banded = BAND && hw > 0;
  const int ntile = (L + TW) / TW;
  int par = 0;      // the tile's half of the scan's double buffer
  const int nwin = max(max(abs(c.ma), abs(c.mm)), abs(gp));
  const bool zero = c.ma == 0 || c.mm == 0 || gp == 0;
  for (int r = r_lo; r < r_hi; ++r) {
    const int u = s.order[r];
    const int ub = s.base[u];
    const int cexp = BAND ? (int)(s.key[u] + 0.5f) - begin : 0;
    const unsigned long long dsc = s.desc[r];
    const bool any = dsc & D_ANY, stale = dsc & D_STALE;
    const int first = (int)(dsc >> D_FIRST) & 63;
    int* hrow = w.H + (size_t)(u + 1) * HS;
    uint8_t* mrow = w.MV + (size_t)(u + 1) * HS;
    int carry = INT_MIN;  // the row's running max before the tile
    for (int t = 0; t < ntile; ++t) {
      const int j0 = t * TW + tid * CHM;
      int* lft = s.left + t * NT + tid;
      int jc[CHM + 1];
#pragma unroll
      for (int k = 0; k <= CHM; ++k) jc[k] = min(max(j0 - 1 + k, 0), L);
      int sc[CHM];
#pragma unroll
      for (int k = 0; k < CHM; ++k) {
        const int j = j0 + k;
        sc[k] = j >= 1 && j <= L && s.seq[j - 1] == ub ? c.ma : c.mm;
      }
      // one predecessor row at the thread's columns jc, from the global H
      // (sv < 0: the node is order[rk])
      auto pred_row = [&](int sv, int rk, int* v) {
        const int node = sv >= 0 ? sv : s.order[rk];
        const int* hr = w.H + (size_t)(node + 1) * HS;
#pragma unroll
        for (int k = 0; k <= CHM; ++k) v[k] = hr[jc[k]];
        if (r - rk == 1 && j0 >= 1) v[0] = *lft;
      };
      int M[CHM + 1], S[CHM + 1];
#pragma unroll
      for (int k = 0; k <= CHM; ++k) {
        M[k] = NONE_;
        S[k] = VSLOT;
      }
      bool near = false;
      auto take = [&](int sv, int rk, int slot) {
        int v[CHM + 1];
        pred_row(sv, rk, v);
#pragma unroll
        for (int k = 0; k <= CHM; ++k) {
          if (v[k] > M[k]) { M[k] = v[k]; S[k] = slot; }
          if (BAND)
            near |= (zero || v[k] != NEG_) &&
                    (unsigned)(v[k] - (NEG_ - nwin)) <= 2u * nwin;
        }
      };
      if (!(dsc & D_SLOW)) {
        const int np = (int)(dsc & 3);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (i < np) {
            const int ent = (int)(dsc >> (D_ENT + 17 * i)) & 0x1ffff;
            take(-1, r - (ent & 0xfff), ent >> 12);
          }
        }
      } else {
        for (int e = 0; e < c.E; ++e) {
          const int sv = s.src[(size_t)u * c.ES + e];
          if (sv < 0) break;
          const int rk = s.rank_of[sv];
          if (rk >= r_lo && rk < r) take(sv, rk, e);
        }
      }
      int P[CHM + 1];
      if (!any) {
#pragma unroll
        for (int k = 0; k <= CHM; ++k) {
          P[k] = M[k] = (j0 - 1 + k) * gp;
          if (BAND)
            near |= (zero || P[k] != NEG_) &&
                    (unsigned)(P[k] - (NEG_ - nwin)) <= 2u * nwin;
        }
      } else {
#pragma unroll
        for (int k = 0; k <= CHM; ++k) P[k] = max(M[k], NEG_);
      }
      int offrec[(CHM + 3) / 4];
#pragma unroll
      for (int q = 0; q < (CHM + 3) / 4; ++q) offrec[q] = MV_LEFT * 0x01010101;
      if (BAND && near) {
        int dq[CHM], uq[CHM];
#pragma unroll
        for (int k = 0; k < CHM; ++k) {
          dq[k] = !any && P[k] == NEG_ - sc[k] ? VSLOT : NOSLOT;
          uq[k] = !any && P[k + 1] == NEG_ - gp ? VSLOT : NOSLOT;
        }
        for (int e = 0; any && e < c.E; ++e) {
          const int sv = s.src[(size_t)u * c.ES + e];
          if (sv < 0) break;
          const int rk = s.rank_of[sv];
          if (rk < r_lo || rk >= r) continue;
          int v[CHM + 1];
          pred_row(sv, rk, v);
#pragma unroll
          for (int k = 0; k < CHM; ++k) {
            if (dq[k] == NOSLOT && v[k] == NEG_ - sc[k]) dq[k] = e;
            if (uq[k] == NOSLOT && v[k + 1] == NEG_ - gp) uq[k] = e;
          }
        }
#pragma unroll
        for (int k = 0; k < CHM; ++k) {
          const int mv = j0 + k >= 1 && dq[k] != NOSLOT ? MV_DIAG | dq[k] << 2
                         : uq[k] != NOSLOT              ? MV_UP | uq[k] << 2
                                                        : MV_LEFT;
          offrec[k >> 2] ^= (mv ^ MV_LEFT) << (8 * (k & 3));
        }
      }
      int x[CHM];
      int run = INT_MIN;
#pragma unroll
      for (int k = 0; k < CHM; ++k) {
        const int j = j0 + k;
        int v = INT_MIN;
        if (j <= L) {
          v = P[k + 1] + gp;
          if (j >= 1)
            v = max(v, P[k] + sc[k]);
          else if (banded)
            v = max(v, NEG_ + c.mm);
          v -= j * gp;
        }
        run = max(run, v);
        x[k] = run;
      }
      // the block's inclusive max-scan of the thread totals, after carry
      int tot = run;
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, tot, d);
        if (lane >= d) tot = max(tot, o);
      }
      int* scan = s.scan + par * NWARP;
      par ^= 1;
      if (lane == 31) scan[wid] = tot;
      int excl = __shfl_up_sync(0xffffffffu, tot, 1);
      if (lane == 0) excl = INT_MIN;
      __syncthreads();
      int tmax = carry;
      for (int q = 0; q < NWARP; ++q) {
        const int sq = scan[q];
        if (q < wid) excl = max(excl, sq);
        tmax = max(tmax, sq);
      }
      excl = max(excl, carry);
      carry = tmax;
#pragma unroll
      for (int k = 0; k < CHM; ++k) {
        const int j = j0 + k;
        if (j <= L) {
          int row = max(x[k], excl) + j * gp;
          const bool off = banded && abs(j - cexp) > hw;
          if (off) row = NEG_;
          hrow[j] = row;
          int mv = MV_LEFT;
          if (stale) {
            mv = MV_REDERIVE;
          } else if (banded && j == 0 && row == NEG_ + c.mm) {
            mv = MV_DIAG | first << 2;
          } else if (off) {
            mv = (offrec[k >> 2] >> (8 * (k & 3))) & 0xff;
          } else if (j >= 1 && row == M[k] + sc[k]) {
            mv = MV_DIAG | S[k] << 2;
          } else if (row == M[k + 1] + gp) {
            mv = MV_UP | S[k + 1] << 2;
          }
          mrow[j] = (uint8_t)mv;
          if (j == L) s.esc[r] = row;
        }
      }
      if (j0 >= 1 && j0 - 1 <= L)
        *lft = banded && abs(j0 - 1 - cexp) > hw ? NEG_
                                                 : excl + (j0 - 1) * gp;
    }
  }
  __syncthreads();
}

// The plain version's move at (u, j), re-derived from the finished rows of
// H: diagonal before up, each through the first slot whose row explains the
// cell, else left; col0 (the banded walk): column 0 has a diagonal where
// the cell is NEG + mismatch. *next gets the predecessor, -1 for the
// virtual row.
template <class Sh>
__device__ int rederive(const Sh& s, const Cfg& c, const Win& w, int u,
                        int j, int r_lo, int r_hi, bool col0, int* next) {
  const int HS = c.ML + 1;
  const int cur = w.H[(size_t)(u + 1) * HS + j];
  const int jm1 = max(j - 1, 0);
  const int sc = s.seq[jm1] == s.base[u] ? c.ma : c.mm;
  const bool d0 = col0 && j == 0 && cur == NEG_ + c.mm;
  int diag = -2, up = -2;  // -2: no such move
  bool any = false;
  for (int e = 0; e < c.E; ++e) {
    const int sv = s.src[(size_t)u * c.ES + e];
    if (sv < 0) break;
    const int rk = s.rank_of[sv];
    if (rk < r_lo || rk >= r_hi) continue;
    any = true;
    const int* hr = w.H + (size_t)(sv + 1) * HS;
    if (diag == -2 && (d0 || (j > 0 && hr[jm1] + sc == cur))) diag = sv;
    if (up == -2 && hr[j] + c.gp == cur) up = sv;
  }
  if (!any) {
    if (d0 || (j > 0 && jm1 * c.gp + sc == cur)) diag = -1;
    if (j * c.gp + c.gp == cur) up = -1;
  }
  if (diag != -2) { *next = diag; return MV_DIAG; }
  if (up != -2) { *next = up; return MV_UP; }
  return MV_LEFT;
}

// The walk's state: the cell (u, j), steps taken, and the insertion run and
// next matched key being written.
struct Walk {
  int u, j, tb, run;
  float nk;
};

#define AT_UP 32    // walk codes of the cell a move leads to: diagonal
#define AT_LEFT 64  // through slot e is e, up AT_UP + e, left AT_LEFT

// One trip to memory (warp 0): returns the record of (u, j); *got gets the
// lane's share of the records one move from it. With max_edges <= 15, one
// byte a lane: lane e the diagonal through slot e, lane 15 + e up through
// slot e, lane 30 left; with more slots lane e holds slot e's diagonal
// and up records (bytes 0 and 1) and every lane the left one (byte 2).
template <class Sh>
__device__ __forceinline__ int fetch(const Sh& s, const Cfg& c,
                                     const Win& w, const Walk& k, int lane,
                                     int* got) {
  const int HS = c.ML + 1;
  const uint8_t* mrow = w.MV + (size_t)(k.u + 1) * HS;
  const int left = k.j > 0 ? mrow[k.j - 1] : 0;
  int g = 0;
  if (c.E <= 15) {
    const int e = lane < 15 ? lane : lane - 15;
    const int sv = lane < 30 && e < c.E ? s.src[(size_t)k.u * c.ES + e] : -1;
    if (lane == 30)
      g = left;
    else if (sv >= 0 && (lane >= 15 || k.j > 0))
      g = w.MV[(size_t)(sv + 1) * HS + k.j - (lane < 15)];
  } else {
    if (lane < c.E) {
      const int sv = s.src[(size_t)k.u * c.ES + lane];
      if (sv >= 0) {
        const uint8_t* prow = w.MV + (size_t)(sv + 1) * HS;
        g = (k.j > 0 ? prow[k.j - 1] : 0) | prow[k.j] << 8;
      }
    }
    g |= left << 16;
  }
  *got = g;
  return mrow[k.j];
}

// The record of the cell a move leads to, from a fetch's lanes (walk code
// `at`; every lane of warp 0 the same).
__device__ __forceinline__ int pick(const Cfg& c, int got, int at) {
  if (c.E <= 15)
    return __shfl_sync(0xffffffffu, got,
                       at == AT_LEFT ? 30 : at >= AT_UP ? 15 + at - AT_UP : at);
  const int v = __shfl_sync(0xffffffffu, got, at >= AT_UP ? (at - AT_UP) & 31 : at);
  return (v >> (at == AT_LEFT ? 16 : at >= AT_UP ? 8 : 0)) & 0xff;
}

// The move at cell (u, j) whose record is rec: its kind; for a diagonal or
// up move the predecessor in *prd (-1: the virtual row); in *at the walk
// code of the cell the move leads to, or -1 where no fetch holds it (a
// re-derived move, the virtual row).
template <class Sh>
__device__ __forceinline__ int decide(const Sh& s, const Cfg& c,
                                      const Win& w, const Walk& k, int rec,
                                      int r_lo, int r_hi, bool col0,
                                      int* prd, int* at) {
  int move = rec & 3;
  const int sl = rec >> 2;
  *prd = -1;
  *at = -1;
  if (move == MV_REDERIVE) {
    move = rederive(s, c, w, k.u, k.j, r_lo, r_hi, col0, prd);
    if (move == MV_LEFT) *at = AT_LEFT;
  } else if (move == MV_LEFT) {
    *at = AT_LEFT;
  } else if (sl != VSLOT) {
    *prd = s.src[(size_t)k.u * c.ES + sl];
    *at = move == MV_UP ? AT_UP + sl : sl;
  }
  return move;
}

// Lane 0 writes position j's next matched key and remaining run.
template <class Sh>
__device__ __forceinline__ void mark(const Sh& s, const Walk& k,
                                     int lane) {
  if (lane == 0) { s.nkey[k.j] = k.nk; s.runrem[k.j] = k.run; }
}

// The flat traceback (warp 0) from end node start_u at column L, as the
// plain version's: diagonal, up and left moves until the virtual row at
// column 0; the walk fails where it runs off column 0 or out of steps, or
// where the subgraph is empty. Writes each position's next matched key and
// remaining run. Two steps a trip to memory.
template <class Sh>
__device__ void walk_flat(const Sh& s, const Cfg& c, const Win& w,
                          int start_u, int L, int n_sub, int r_lo,
                          int r_hi) {
  const int lane = threadIdx.x & 31;
  const int limit = c.N + c.ML + 2;
  Walk k{start_u, L, 0, c.ML - L, INFINITY};
  bool off = false;  // ran off column 0
  // one step from the cell's record; returns the walk code of the next cell
  auto step = [&](int rec) {
    ++k.tb;
    int prd, at;
    const int move = decide(s, c, w, k, rec, r_lo, r_hi, false, &prd, &at);
    if (move == MV_DIAG) {       // position j-1 matches u
      k.nk = s.key[k.u];
      k.run = 0;
      --k.j;
      mark(s, k, lane);
      k.u = prd;
    } else if (move == MV_UP) {
      k.u = prd;
    } else {                     // left: position j-1 is inserted
      --k.j;
      if (k.j < 0) {
        off = true;
        return -1;
      }
      ++k.run;
      mark(s, k, lane);
    }
    return k.u < 0 ? -1 : at;
  };
  while (n_sub > 0 && !(k.u == -1 && k.j == 0) && k.tb < limit) {
    if (k.u == -1) {             // virtual row: only left moves
      ++k.tb;
      --k.j;
      ++k.run;
      mark(s, k, lane);
      continue;
    }
    int got;
    const int at = step(fetch(s, c, w, k, lane, &got));
    const int rec2 = pick(c, got, at < 0 ? 0 : at);
    if (off) break;
    if (at < 0 || (k.u == -1 && k.j == 0) || k.tb >= limit) continue;
    step(rec2);
    if (off) break;
  }
  if (lane == 0) {
    if (!(k.u == -1 && k.j == 0)) s.misc[1] = 1;
    for (int jj = k.j - 1; jj >= 0; --jj) {  // positions the walk missed
      s.nkey[jj] = k.nk; s.runrem[jj] = ++k.run;
    }
  }
}

// The banded build's traceback (warp 0), the ls build's walk: from end node
// start_u at column L, at each node left to the first cell a diagonal or up
// move explains, then that move; it fails where a node is stuck (no such
// cell at or left of its entry, or out of steps) and where a diagonal
// leaves column 0 into a node, and ends on the virtual row, whose positions
// left are insertions. Sets the band hit where a node the walk left had a
// visited cell within one cell of the band edge, and the failed flag where
// the walk fails. Two steps a trip to memory.
template <class Sh>
__device__ void walk_band(const Sh& s, const Cfg& c, const Win& w,
                          int start_u, int L, int r_lo, int r_hi, int hw,
                          int begin) {
  const int lane = threadIdx.x & 31;
  const int limit = c.N + c.ML + 2;
  Walk k{start_u, L, 0, c.ML - L, INFINITY};
  bool hit = false, near = false, ok = true, done = false;
  int cexp = (int)(s.key[k.u] + 0.5f) - begin;
  // one step from the cell's record (the cell exists: j >= 0 and a step
  // left); returns the walk code of the next cell
  auto step = [&](int rec) {
    ++k.tb;
    near |= abs(k.j - cexp) >= hw - 1;
    int prd, at;
    const int move = decide(s, c, w, k, rec, r_lo, r_hi, true, &prd, &at);
    if (move == MV_LEFT) {       // within the node's insertion run
      --k.j;
      ++k.run;
      if (k.j >= 0) mark(s, k, lane);
      return at;
    }
    hit |= near;
    near = false;
    if (move == MV_DIAG) {
      if (k.j == 0) {            // a diagonal off column 0
        ok = prd == -1;
        done = true;
        return -1;
      }
      k.nk = s.key[k.u];
      k.run = 0;
      --k.j;
      mark(s, k, lane);
    }
    k.u = prd;
    if (k.u < 0) {               // the virtual row
      done = true;
      return -1;
    }
    cexp = (int)(s.key[k.u] + 0.5f) - begin;
    return at;
  };
  while (!done) {
    if (k.j < 0 || k.tb >= limit) {  // stuck
      ok = false;
      break;
    }
    int got;
    const int at = step(fetch(s, c, w, k, lane, &got));
    const int rec2 = pick(c, got, at < 0 ? 0 : at);
    if (done || at < 0 || k.j < 0 || k.tb >= limit) continue;
    step(rec2);
  }
  if (lane == 0) {
    if (hit) s.misc[6] = 1;
    if (!ok) s.misc[1] = 1;
    for (int jj = k.j - 1; jj >= 0; --jj) {  // the virtual row's positions
      s.nkey[jj] = k.nk; s.runrem[jj] = ++k.run;
    }
  }
}

// The graph update of a layer of length L and weights wq over the n old
// nodes, by the block: each matched position's old node in parallel, then
// warp 0 walks the positions in order, giving new nodes their ids and
// adding each edge with weight w[j-1] + w[j].
template <class Sh>
__device__ void update(const Sh& s, const Cfg& c, const Win& w, int n,
                       int L, const int* wq) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int jj = tid; jj < L; jj += NT) {
    s.wts[jj] = wq[jj];
    s.found[jj] = (typename Sh::Id)(s.runrem[jj] == 0
                                        ? find_old(s, n, s.nkey[jj], s.seq[jj])
                                        : -1);
  }
  __syncthreads();
  if (tid >= 32) return;
  int nn = n;
  int failed = s.misc[1];
  int prev = -1, prev_w = 0;
  float prev_key = -1.0f;
  for (int jj = 0; jj < L; ++jj) {
    const int b = s.seq[jj];
    const int wj = s.wts[jj];
    const float nkj = s.nkey[jj];
    const int run_j = s.runrem[jj];
    const bool is_match = run_j == 0;  // nkey[jj] is the matched key
    int found = is_match ? s.found[jj] : -1;
    if (is_match && found < 0 && nn > n)
      found = find_new(s, n, nn, nkj, b, lane);
    float key_val = nkj;
    if (!is_match) {             // an insertion between its neighbours
      const float hi2 = isfinite(nkj) ? nkj : prev_key + 1.0f;
      const float rr = (float)run_j;
      const float lo2 = prev >= 0 ? prev_key : hi2 - rr - 1.0f;
      key_val = lo2 + (hi2 - lo2) / (rr + 1.0f);
    }
    const bool overflow = found < 0 && nn >= c.N;
    int nid;
    float nid_key;               // the next position's prev_key
    if (found >= 0) {
      nid = found;
      nid_key = s.key[nid];
    } else {
      nid = min(nn, c.N - 1);
      if (!overflow) {
        if (lane == 0) { s.base[nid] = (uint8_t)b; s.key[nid] = key_val; }
        ++nn;
        nid_key = key_val;
      } else {
        nid_key = s.key[nid];
      }
    }
    if (overflow) {
      failed = 1;
    } else {
      if (lane == 0) s.cov[nid] += 1;
      if (prev >= 0 && !poa_common::add_edge(s.src, w.ew, c.E, c.ES, nid,
                                             prev, prev_w + wj, lane))
        failed = 1;
    }
    __syncwarp();
    prev = nid;
    prev_key = nid_key;
    prev_w = wj;
  }
  if (lane == 0) { s.misc[0] = nn; s.misc[1] = failed; }
}

// GSRC: the in-edge sources live in the window's global scratch (where the
// graph is too large to keep them in shared memory). BAND: the banded
// build, which takes each window's half band (wband_a; 0 runs the flat
// code) and writes its band hit (band_hit_out). CX: the most columns a
// thread owns, CHMAX or, in the wide build, CHWIDE; CHGLOBAL is the global
// build (the graph in the global scratch, rows in tiles; GSRC). IdT: the
// node ids' type, int32 only in the global build above INT16_NODES node
// slots (poa_common::wide_ids).
template <bool GSRC, bool BAND, int CX, typename IdT = int16_t>
__global__ void __launch_bounds__(NT, CX == CHWIDE ? 1 : 2)
poa_kernel(Cfg c, const uint8_t* __restrict__ bb, const int* __restrict__ bbw,
           const int* __restrict__ bb_len_a, const int* __restrict__ n_layers_a,
           const uint8_t* __restrict__ seqs, const int* __restrict__ ws,
           const int* __restrict__ lens, const int* __restrict__ begins,
           const int* __restrict__ ends, const int* __restrict__ wband_a,
           int* __restrict__ cons_base,
           int* __restrict__ cons_cov, int* __restrict__ cons_len,
           uint8_t* __restrict__ failed_out, int* __restrict__ n_nodes,
           uint8_t* __restrict__ band_hit_out,
           long long* __restrict__ cells, long long* __restrict__ phases,
           int* __restrict__ scratch, size_t scratch_per) {
  extern __shared__ __align__(16) char smem[];
  const int N = c.N, ML = c.ML, E = c.E, ES = c.ES;
  const int win = blockIdx.x;
  const int tid = threadIdx.x, wid = tid >> 5;
  constexpr bool GLB = CX == CHGLOBAL;
  static_assert(GLB || sizeof(IdT) == 2, "int32 ids: the global build only");
  size_t so[5];
  scratch_layout(N, ML, ES, GLB, so);
  int* const wbase = scratch + (size_t)win * scratch_per;
  ShT<IdT> s = [&] {
    if constexpr (GLB)
      return carve_global(smem, (char*)(wbase + so[3]), N, ML,
                          (IdT*)(wbase + so[1]));
    else
      return carve(smem, N, ML, ES, c.ring,
                   GSRC ? (int16_t*)(wbase + so[1]) : nullptr);
  }();
  const poa_common::Red red{s.red_v, s.red_w, s.red_i};
  // Thread 0 adds the cycles since the last mark to phase k's sum.
  long long tmark = clock64();
#define PHASE(k)                                 \
  if (tid == 0) {                                \
    const long long t_ = clock64();              \
    s.ph[k] += t_ - tmark;                       \
    tmark = t_;                                  \
  }

  Win w;
  w.H = wbase;
  w.ew = wbase + so[0];
  w.MV = (uint8_t*)(wbase + so[2]);

  const int bb_len = bb_len_a[win];
  const int hw = BAND ? wband_a[win] : 0;
  const uint8_t* bbp = bb + (size_t)win * c.MB;
  const int* bbwp = bbw + (size_t)win * c.MB;

  // --- graph init: backbone chain; keys 0..bb_len-1 are already sorted
  for (int i = tid; i < N; i += NT) {
    const bool used = i < bb_len;
    s.base[i] = used ? bbp[i] : 0xff;
    s.key[i] = used ? (float)i : INFINITY;
    s.order[i] = (IdT)i;
    s.cov[i] = used ? 1 : 0;
    for (int e = 0; e < ES; ++e) {
      s.src[(size_t)i * ES + e] = -1;
      w.ew[(size_t)i * ES + e] = 0;
    }
    if (used && i > 0) {
      s.src[(size_t)i * ES] = (IdT)(i - 1);
      w.ew[(size_t)i * ES] = bbwp[i - 1] + bbwp[i];
    }
  }
  if (tid == 0) {
    s.misc[0] = bb_len;  // n
    s.misc[1] = 0;       // failed
    s.misc[6] = 0;       // band hit
    for (int k = 0; k < NPHASE; ++k) s.ph[k] = 0;
  }
  __syncthreads();

  const int nl = n_layers_a[win];
  long long dp_cells = 0;  // the layers' DP cells, as the plain version counts
  for (int li = 0; li < nl; ++li) {
    const int L = lens[(size_t)win * c.D + li];
    if (L <= 0 || s.misc[1]) continue;
    const int n = s.misc[0];
    const int begin = begins[(size_t)win * c.D + li];
    const int end = ends[(size_t)win * c.D + li];
    const int offset = (int)(0.01f * (float)bb_len);
    const bool full = begin < offset && end > bb_len - offset;
    const float lo = full ? -INFINITY : (float)begin;
    const float hi = full ? INFINITY : (float)end;

    const uint8_t* sq = seqs + ((size_t)win * c.D + li) * ML;
    const int* wq = ws + ((size_t)win * c.D + li) * ML;
    for (int j = tid; j < ML; j += NT) s.seq[j] = j < L ? sq[j] : 0;
    for (int r = tid; r < n; r += NT) {
      s.rank_of[s.order[r]] = (IdT)r;
      s.has_out[r] = 0;
      s.far[r] = 0;
    }
    if (tid == 0) {
      s.misc[2] = count_keys(s, n, lo, false);  // r_lo
      s.misc[3] = count_keys(s, n, hi, true);   // r_hi, within [0, n)
      s.misc[5] = 0;                            // band cells
    }
    __syncthreads();
    const int r_lo = s.misc[2], r_hi = s.misc[3];
    const int n_sub = r_hi - r_lo;
    const bool banded = BAND && hw > 0;
    // Before the DP, in parallel: each row's descriptor (D_*), the nodes
    // with an out-edge inside the subgraph, the rows that a row c.ring or
    // more ranks later reads (from the global H), whether some row has an
    // in-subgraph predecessor not computed before it (then every row goes
    // to the global H, for the walk's re-derivation), and the band's cells.
    int late = 0, band_cells = 0;
    for (int r = r_lo + tid; r < r_hi; r += NT) {
      const int u0 = s.order[r];
      if (banded) {  // the columns of [0, L] the row's band admits
        const int ce = (int)(s.key[u0] + 0.5f) - begin;
        band_cells += max(0, min(L, ce + hw) - max(0, ce - hw) + 1);
      }
      unsigned long long dsc = 0;
      int np = 0, first = -1;
      for (int e = 0; e < E; ++e) {
        const int sv = s.src[(size_t)u0 * ES + e];
        if (sv < 0) break;
        const int rk = s.rank_of[sv];
        if (rk < r_lo || rk >= r_hi) continue;
        s.has_out[sv] = 1;
        if (first < 0) first = e;
        if (rk >= r) {
          late = 1;
          dsc |= D_STALE;
          continue;
        }
        const int d = r - rk;
        if (d >= c.ring) s.far[rk] = 1;
        if (np < 3 && d < 4096)
          dsc |= (unsigned long long)(d | e << 12) << (D_ENT + 17 * np++);
        else
          dsc |= D_SLOW;
      }
      s.desc[r] = dsc | np | (first >= 0 ? D_ANY : 0) |
                  (unsigned long long)(first >= 0 ? first : VSLOT) << D_FIRST;
    }
    if (banded) atomicAdd(&s.misc[5], band_cells);
    const bool all_global = __syncthreads_or(late);
    dp_cells += banded ? (long long)atomicAdd(&s.misc[5], 0)
                       : (long long)n_sub * (L + 1);
    PHASE(0);

    // --- DP over the subgraph in rank order
    if constexpr (GLB)
      dp_layer_tiled<BAND>(s, c, w, r_lo, r_hi, L, hw, begin);
    else
      dp_layer_ch<CX, BAND>(s, c, w, r_lo, r_hi, L, all_global, hw, begin);
    PHASE(1);

    // --- end node: first best end score in rank order among subgraph
    // nodes with no out-edge inside the subgraph
    int ba = INT_MIN, bbv = 0, bi = -1;
    for (int r = r_lo + tid; r < r_hi; r += NT) {
      const int sc = s.has_out[s.order[r]] ? NEG_ : s.esc[r];
      if (bi < 0 || better(sc, 0, r, ba, bbv, bi)) { ba = sc; bi = r; }
    }
    block_best(red, ba, bbv, bi);
    const int start_u = bi >= 0 ? s.order[bi] : 0;
    // rule 1 (banded): no end score above NEG fails the layer
    const int best_s = bi >= 0 ? max(ba, NEG_) : NEG_;
    if (banded && tid == 0) {
      if (c.ma * L - best_s > 2 * (-c.gp) * max(hw / 2, 1)) s.misc[6] = 1;
      if (best_s <= NEG_) s.misc[1] = 1;
    }
    PHASE(2);

    // --- traceback (warp 0)
    if (wid == 0) {
      if (!banded)
        walk_flat(s, c, w, start_u, L, n_sub, r_lo, r_hi);
      else if (best_s > NEG_)
        walk_band(s, c, w, start_u, L, r_lo, r_hi, hw, begin);
    }
    __syncthreads();
    PHASE(3);

    // --- graph update, then the new nodes merged into the rank order;
    // rule 2 (banded): a layer that failed adds nothing
    if (!(banded && s.misc[1])) {
      update(s, c, w, n, L, wq);
      __syncthreads();
      PHASE(4);
      if (s.misc[0] > n) merge_new(s, n, s.misc[0]);
      PHASE(5);
    }
  }
  PHASE(0);  // the graph init when no layer ran; else the last skip

  // --- consensus; score in esc, pred in rank_of
  const int n = s.misc[0];
  const int cnt = poa_common::consensus(
      s.order, s.base, n, N, E, ES, s.src, w.ew, s.cov, s.esc, s.rank_of,
      s.path, &s.misc[4], red, cons_base + (size_t)win * N,
      cons_cov + (size_t)win * N);
  if (tid == 0) {
    cons_len[win] = cnt;
    failed_out[win] = s.misc[1] ? 1 : 0;
    if (BAND) band_hit_out[win] = s.misc[6] ? 1 : 0;
    n_nodes[win] = n;
    if (cells) cells[win] = dp_cells;
  }
  PHASE(6);
  if (phases && tid == 0)
    for (int k = 0; k < NPHASE; ++k)
      phases[(size_t)k * gridDim.x + win] = s.ph[k];
#undef PHASE
}

// The launch's plan (poa_common::plan) for this kernel's layout.
cudaError_t plan(int N, int ML, int ES, int* ring, bool* gsrc, bool* glob,
                 size_t* sm) {
  return poa_common::plan(N, ML, ES, RING, shared_bytes, ring, gsrc, glob,
                          sm);
}

using Kernel = decltype(&poa_kernel<false, false, CHMAX>);

// The kernel instantiation a plan launches (the banded build where band;
// the global build where glob, with int32 node ids where ids32, else the
// wide one where wide, which the plan gives gsrc), with its shared-memory
// limit raised to sm.
cudaError_t planned_kernel(bool gsrc, bool band, bool wide, bool glob,
                           bool ids32, size_t sm, Kernel* fn) {
  if (glob && ids32)
    *fn = band ? &poa_kernel<true, true, CHGLOBAL, int32_t>
               : &poa_kernel<true, false, CHGLOBAL, int32_t>;
  else if (glob)
    *fn = band ? &poa_kernel<true, true, CHGLOBAL>
               : &poa_kernel<true, false, CHGLOBAL>;
  else if (wide)
    *fn = band ? &poa_kernel<true, true, CHWIDE>
               : &poa_kernel<true, false, CHWIDE>;
  else if (gsrc)
    *fn = band ? &poa_kernel<true, true, CHMAX>
               : &poa_kernel<true, false, CHMAX>;
  else
    *fn = band ? &poa_kernel<false, true, CHMAX>
               : &poa_kernel<false, false, CHMAX>;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sm);
}

}  // namespace

extern "C" {

// Scratch int32 words per window (scratch_layout), for the global build
// where glob.
long long rt_poa_scratch_words(int N, int ML, int E, int glob) {
  size_t off[5];
  scratch_layout(N, ML, edge_stride(E), glob != 0, off);
  return (long long)off[4];
}

// The plan at (N, ML, E), the same for the flat and the banded build
// (band): out[0] the ring's rows, out[1] 1 where the in-edge sources are in
// shared memory, out[2] the dynamic shared bytes a block, out[3] 1 for the
// global build.
int rt_poa_plan(int N, int ML, int E, int band, int* out) {
  (void)band;
  int ring = 0;
  bool gsrc = false, glob = false;
  size_t sm = 0;
  const cudaError_t err =
      plan(N, ML, edge_stride(E), &ring, &gsrc, &glob, &sm);
  out[0] = ring;
  out[1] = gsrc ? 0 : 1;
  out[2] = (int)sm;
  out[3] = glob ? 1 : 0;
  return (int)err;
}

// One block per window. Inputs: bb u8[B,MB], bbw i32[B,MB], bb_len i32[B],
// n_layers i32[B], seqs u8[B,D,ML], ws i32[B,D,ML], lens/begins/ends
// i32[B,D], and wband i32[B] or null: each window's half band (the banded
// build; null runs the flat build). Outputs: cons_base, cons_cov i32[B,N],
// cons_len i32[B], failed u8[B], n_nodes i32[B], band_hit u8[B] (with
// wband); cells i64[B] (may be null): each window's DP cells, sum over its
// layers of subgraph nodes x (layer length + 1), or under a half band the
// columns of [0, L] each row's band admits; phases i64[NPHASE, B] (may be
// null): each window's clock64() cycles in graph init and layer set-up,
// DP, end-node pick, traceback, graph update, rank-order merge and
// consensus, as thread 0 sees them.
// scratch i32[B, rt_poa_scratch_words(..., the plan's global build)].
// Node ids are int16, int32 in the global build above INT16_NODES.
int rt_poa_launch(int N, int ML, int MB, int E, int D, int ma, int mm,
                  int gp, const void* bb, const void* bbw, const void* bb_len,
                  const void* n_layers, const void* seqs, const void* ws,
                  const void* lens, const void* begins, const void* ends,
                  const void* wband, void* cons_base, void* cons_cov,
                  void* cons_len, void* failed, void* n_nodes, void* band_hit,
                  void* cells, void* phases, void* scratch, int B,
                  void* stream) {
  if (E > 32) return (int)cudaErrorInvalidValue;
  const int ES = edge_stride(E);
  int ring = 0;
  bool gsrc = false, glob = false;
  size_t sm = 0;
  cudaError_t err = plan(N, ML, ES, &ring, &gsrc, &glob, &sm);
  Kernel fn = nullptr;
  if (err == cudaSuccess)
    err = planned_kernel(gsrc, wband != nullptr, wide_build(ML), glob,
                         wide_ids(N, glob), sm, &fn);
  if (err != cudaSuccess) return (int)err;
  Cfg c{N, ML, MB, E, ES, D, ma, mm, gp, ring};
  const size_t per = (size_t)rt_poa_scratch_words(N, ML, E, glob);
  fn<<<B, NT, sm, (cudaStream_t)stream>>>(
      c, (const uint8_t*)bb, (const int*)bbw, (const int*)bb_len,
      (const int*)n_layers, (const uint8_t*)seqs, (const int*)ws,
      (const int*)lens, (const int*)begins, (const int*)ends,
      (const int*)wband, (int*)cons_base, (int*)cons_cov, (int*)cons_len,
      (uint8_t*)failed, (int*)n_nodes, (uint8_t*)band_hit, (long long*)cells,
      (long long*)phases, (int*)scratch, per);
  return (int)cudaGetLastError();
}

// The kernel's registers a thread, local (spill) bytes a thread, dynamic
// shared bytes a block and resident blocks per SM at (N, ML) with 12 edge
// slots, as the launch plans them, for the flat build or (band) the banded
// one (the wide instantiation where max_len + 1 > NT * CHMAX, the global
// one where the plan says so); out[4].
int rt_poa_occupancy(int N, int ML, int band, int* out) {
  int ring = 0;
  bool gsrc = false, glob = false;
  size_t sm = 0;
  cudaError_t err = plan(N, ML, edge_stride(12), &ring, &gsrc, &glob, &sm);
  Kernel fn = nullptr;
  if (err == cudaSuccess)
    err = planned_kernel(gsrc, band != 0, wide_build(ML), glob,
                         wide_ids(N, glob), sm, &fn);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, (const void*)fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, sm);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)sm;
  out[3] = blocks;
  return (int)err;
}

}  // extern "C"
