// Batched POA window consensus, second tier (poa_kernel="v2"): one thread
// block per window.
//
// Replaces the JAX package's Pallas kernel build_pallas_poa_kernel
// (racon_tpu/ops/poa_pallas.py:73). It computes what the plain version
// ops/poa.py:poa_batch_plain computes, bit for bit, as csrc/poa.cu does.
//
// What bounds it on an H100: one window's serial chain. A launch holds at
// most 256 windows, two blocks on an SM, and lasts as long as its slowest
// window's chain: for each layer, one DP row after another, the end-node
// pick, the traceback and the graph update. Neither bytes nor integer
// throughput come near their limits. The DP rows are most of the chain
// (clock64() phase counts on the card). So the design takes round trips
// to global memory, and instructions, off that chain:
//   * The graph lives on chip. The in-edge sources (int16, N x ES with
//     ES = max_edges rounded up to 4), keys, bases (uint8), the rank order,
//     rank_of and the consensus path (int16) and the node coverage are in
//     dynamic shared memory. Only H, the move bytes and the edge weights
//     are in the global scratch; the update adds to a weight with a
//     fire-and-forget atomic and the consensus reads the weights from L2.
//   * A DP row reads no global memory in the common case. Its in-edge
//     slots are read four at a time (one 8-byte shared load), then their
//     ranks. The last RING rows of H stay in a shared ring by rank, so a
//     near predecessor (columns hold a few nodes) is a few shared loads at
//     32-bit offsets; a far one, a uniform branch, comes from the global H,
//     and only the rows some later row reads from there are written there.
//   * Instructions, not latency alone: two windows share an SM, and their
//     16 warps run the same row code, so a row's instruction count sets
//     its time. The thread's columns are unrolled to the next of 2, 4 or 8
//     at or above its share (2 at w=500), and the predecessor columns it
//     reads are clamped once, not masked per load.
//   * Same-column pairs run at once (colstep). When rank r + 1 shares
//     rank r's key and order[r] is not among order[r + 1]'s in-edges (keys
//     can collide along an edge where float32 runs out of precision), the
//     two rows run on the two halves of the block with one scan-and-barrier
//     pass; otherwise they run one after the other in the same iteration.
//     Each rank's step (one row, or a pair of either kind) is found before
//     the DP, in parallel. The kernel counts its iterations ("steps"),
//     which the plain version counts with ops/colstep.py.
//   * Move records. Beside each DP cell the DP writes one byte,
//     move | pred slot << 2 (0 diagonal, 1 up, 2 left; slot VSLOT = the
//     virtual start row): diagonal before up on ties, left only if strictly
//     better, the first slot that attains the maximum: the move the plain
//     traceback re-derives from H. The traceback (warp 0) fetches, with one
//     trip to global memory, the move byte of its cell and those of every
//     cell a move from it can reach: two steps a trip.
//   * The graph update freezes the rank order. Each position's matched
//     node is searched in the frozen order, one thread per position; the
//     serial walk (warp 0) only gives new nodes their ids in sequence and
//     adds the edges, and searches the layer's new nodes where a matched
//     key has no old node of the base. After the walk one block-wide pass
//     merges the new nodes into the order by (key, id), which is what
//     inserting each after every key <= its own gives, since every new id
//     is larger than every old one.
//   * End-node selection is fused into the DP sweep (end scores by rank,
//     has_out marked as the DP enumerates in-edges); the pick is one block
//     reduction. The consensus is csrc/poa_common.cuh's, shared with
//     csrc/poa.cu.
// Shared memory is about 107 KB at N=1536, max_len=768 (the ring 24.6 KB
// of it), so two blocks fit an SM: 264 slots for the 256 windows of the
// largest batches. The graph grows with the window (N = 3 w, max_len =
// 1.5 w), so each launch plans its shared memory against the card's limit
// a block: the ring holds 8, 4 or 2 rows, the largest that fits (a row
// further back comes from the global H), and where even 2 do not, the
// in-edge sources move to the global scratch (the kernel's GSRC
// instantiation). The plan fits every geometry the ls kernel takes.
//
// A predecessor whose row is not computed yet in this layer (possible only
// where float32 keys collide along an edge and the edge's source has the
// larger node id) counts as a row of NEG in the DP, as in the plain version.
// The plain traceback then reads that predecessor's finished row, which the
// DP did not see, so such a row's cells record MV_REDERIVE and the
// traceback re-derives their moves from H as the plain version does. Float
// discipline: keys are float32 in the plain version's order of operations;
// the library is built with --fmad=false and IEEE division.
//
// The banded build (template BAND; the wrapper's wband argument) replaces
// the Pallas kernel's band=True build: a per-window half band wband in, a
// band hit out. Under wband > 0 each DP row is masked to NEG outside
// |j - cexp| <= wband after its gap pass (cexp: the node's key + 0.5,
// truncated, less the layer's begin), column 0's diagonal is NEG +
// mismatch, as the Pallas kernel's shifted-in NEG gives it, and the hit is
// set where the best end score's deficit below match x L passes
// 2 |gap| max(wband / 2, 1) or where the walk comes within one cell of the
// band edge; an end score no better than NEG starts the walk on the virtual
// row. The move records follow the masked row as the Pallas kernel's do: a
// masked cell records the move of its unmasked predecessor maximum (left
// only where NEG beats it). wband = 0 runs the flat DP through the same
// build. Its DP (dp_layer_band) is not the flat build's: before this design
// its clock64() phase counts put the DP rows at about 70% of a launch, each
// row behind two block barriers, decoding its in-edge slots on its chain,
// converting its node's key for the band at every row and spilling at 128
// registers (PERF.md). So, as csrc/poa.cu's rows do, each row runs behind
// one block barrier, with the row before it kept in the registers of the
// threads that own its columns (the cell left of a thread's first column
// is that row's running max there, the thread's own exclusive scan value,
// masked as the row was) and the scan's warp totals in two alternating
// buffers; before the layer, one thread a rank builds the row's 64-bit
// descriptor (up to three computed predecessors as rank distance and slot,
// in slot order, and its flags) and its band start cexp - wband, so that a
// cell's mask is one unsigned compare. Same-column pairs (colstep) do not
// run in the banded build: a pair's rows split the block, so the row before
// would not be in the registers of the threads that read it. Its steps are
// its DP rows. The descriptors take shared memory; the traceback's and the
// update's arrays take the ring's bytes back, dead after the DP.
//
// A thread owns up to CHMAX = 8 columns (max_len + 1 <= 2048). Larger
// windows (max_len + 1 <= 4096, up to backbone class 2048) run the wide
// instantiation (CX = CHWIDE = 16 columns a thread, sources in the global
// scratch, up to 255 registers and one block an SM, which is all their
// shared memory allows anyway), so its registers do not weigh on the usual
// build; a same-column pair whose half-row exceeds the build's columns runs
// as two rows.
//
// The global build (CX = CHGLOBAL), flat and banded. From backbone class
// 2176 up (2432 for the flat build) no shared-memory layout fits a block,
// so plan picks, by geometry and before the launch, a build whose graph,
// rank order, row descriptors, band starts (an array of their own) and
// per-position arrays live in the window's global scratch (carve_global;
// poa_common::graph_layout); shared memory keeps the phase cycles, the
// reductions, the scan's warp totals and misc. Both of its builds run the
// banded build's rows (wband 0 for the flat one, whose outputs are the
// flat DP's, bit for bit) in tiles of TW = NT x CHMAX columns
// (dp_layer_tiled): the scan's running max carried from tile to tile, one
// barrier a tile, every row written to the global H and every predecessor
// row read from there, so max_len has no limit. Same-column pairs do not
// run; the flat build still counts colstep's serial steps (a pair is one
// step), found in the descriptor pass. Node ids and band starts stay int16
// up to N = 32,767 (backbone class 10,880); above it the global build
// takes them as int32 (IdT), which costs scratch bytes, not occupancy.
//
// Thread 0 of each block counts clock64() cycles per phase (NPHASE) for the
// optional phases output.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "poa_common.cuh"

#define VSLOT 15       // pred slot of the virtual start row; max_edges <= 15
#define MV_REDERIVE 3  // move of a row that read an uncomputed predecessor
#define NPHASE 6       // init, DP, end pick, traceback, update, consensus
#define RING 8         // most DP rows of H kept in shared memory, by rank
#define HALF (NT / 2)  // threads of a half block (one row of a pair)
// A banded DP row's descriptor (Shared::desc), built before the layer's
// DP: bits 0-1 the number of computed in-subgraph predecessors listed, then
// flags and up to three entries of 16 bits, rank distance (12 bits) | slot
// << 12, in slot order.
#define D_SLOW 4ull     // more than three, or one 4096 ranks back or more:
                        // the DP reads the in-edge slots
#define D_ANY 8ull      // some in-edge source is in the subgraph
#define D_STALE 16ull   // some in-subgraph source ranks at or after the row
#define D_ENT 5

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
  int N, ML, MB, E, ES, D, ma, mm, gp, colstep;
  int ring;  // DP rows in the shared ring: 8, 4 or 2
};

// The banded build (BAND) keeps desc, scan and bstart, has no step, and
// lays nkey, runrem, wts and found over the ring's bytes (dead after the
// DP).
// Node ids (src, order, rank_of, path, found) and band starts are IdT:
// int16 in every build but the global build above INT16_NODES node slots
// (int32).
template <typename IdT>
struct ShT {
  using Id = IdT;
  long long* ph;     // [NPHASE] thread 0's cycles per phase
  unsigned long long* desc;  // [N] by rank: the DP row's descriptor (D_*)
  int* ring;         // [ring][ML + 1] the last DP rows, slot rank % ring
  float* key;        // [N] column key by node id
  int* esc;          // [N] end score by rank (layers); score (consensus)
  int* cov;          // [N] node coverage
  float* nkey;       // [ML] next matched key at j' >= j (traceback)
  int* runrem;       // [ML] remaining insertion run; 0 marks a match
  int* wts;          // [ML]
  int* red_v;        // [NWARP] reduction scratch
  int* red_i;        // [NWARP]
  int* red_w;        // [NWARP]
  int* scan;         // [2][NWARP] the banded DP rows' warp totals, by row
                     // parity
  int* misc;         // [8]: n, failed, r_lo, r_hi, path count, band
                     // cells of the layer, band hit, colstep pairs of
                     // the layer (global build)
  int* left;         // [n_tiles][NT] (global build): the row just
                     // finished at the cell left of each thread's first
                     // column of each tile
  IdT* src;          // [N][ES] in-edge sources by slot, -1 empty (shared
                     // memory, or the global scratch with GSRC)
  IdT* order;        // [N] node id by rank; [0, n) sorted by (key, id)
  IdT* rank_of;      // [N] rank by node id (layers); pred (consensus)
  IdT* path;         // [N] consensus path; the merged order (update)
  IdT* bstart;       // [N] by rank: the banded DP row's band start,
                     // cexp - wband (path's bytes, unused in the DP)
  IdT* found;        // [ML] each position's matched old node, or -1
  uint8_t* base;     // [N]
  uint8_t* seq;      // [ML]
  uint8_t* has_out;  // [N] node has an out-edge inside the subgraph
  uint8_t* step;     // [N] by rank: 0 one row, 1 or 2 a pair (see DP)
  uint8_t* far;      // [N] by rank: a later row reads this row of H from
                     // the global scratch (not from the ring)
};
using Shared = ShT<int16_t>;  // the shared-memory builds'

// The carve below, as byte offsets, for a ring of `ring` rows and the
// in-edge sources in shared memory unless gsrc; returns the total.
template <bool BAND>
__host__ __device__ inline size_t shared_layout(int N, int ML, int ES,
                                                int ring, bool gsrc,
                                                size_t* off) {
  size_t p = 0;
  const size_t ring_b = (size_t)ring * (ML + 1) * 4;
  if (BAND) {
    off[0] = p; p += NPHASE * 8 + (size_t)N * 8;
    off[1] = p; p += ring_b > (size_t)ML * 14 ? ring_b : (size_t)ML * 14;
    off[2] = p = align16(p); p += (size_t)N * 4 * 3 + NWARP * 4 * 5 + 8 * 4;
    off[3] = p = align16(p); p += (gsrc ? 0 : (size_t)N * ES * 2) +
                                  (size_t)N * 2 * 3;
    off[4] = p; p += (size_t)N * 3 + ML;
    return align16(p);
  }
  off[0] = p; p += NPHASE * 8;
  off[1] = p; p += ring_b;
  off[2] = p; p += (size_t)N * 4 * 3 + (size_t)ML * 4 * 3 + NWARP * 4 * 3 +
                   8 * 4;
  off[3] = p = align16(p); p += (gsrc ? 0 : (size_t)N * ES * 2) +
                                (size_t)N * 2 * 3 + (size_t)ML * 2;
  off[4] = p; p += (size_t)N * 4 + ML;
  return align16(p);
}

template <bool BAND>
__host__ __device__ inline size_t shared_bytes(int N, int ML, int ES,
                                               int ring, bool gsrc) {
  size_t off[5];
  return shared_layout<BAND>(N, ML, ES, ring, gsrc, off);
}

// gsrc: the in-edge sources' global home, or null to carve them here.
template <bool BAND>
__device__ inline Shared carve(char* base, int N, int ML, int ES, int ring,
                               int16_t* gsrc) {
  size_t off[5];
  shared_layout<BAND>(N, ML, ES, ring, gsrc != nullptr, off);
  Shared s;
  s.ph = (long long*)(base + off[0]);
  s.desc = BAND ? (unsigned long long*)(base + off[0] + NPHASE * 8)
                : nullptr;
  s.ring = (int*)(base + off[1]);
  char* p = base + off[BAND ? 1 : 2];
  if (!BAND) {
    s.key = (float*)p; p += N * 4;
    s.esc = (int*)p; p += N * 4;
    s.cov = (int*)p; p += N * 4;
  }
  s.nkey = (float*)p; p += ML * 4;
  s.runrem = (int*)p; p += ML * 4;
  s.wts = (int*)p; p += ML * 4;
  if (BAND) {
    s.found = (int16_t*)p;
    p = base + off[2];
    s.key = (float*)p; p += N * 4;
    s.esc = (int*)p; p += N * 4;
    s.cov = (int*)p; p += N * 4;
  }
  s.red_v = (int*)p; p += NWARP * 4;
  s.red_i = (int*)p; p += NWARP * 4;
  s.red_w = (int*)p; p += NWARP * 4;
  if (BAND) {
    s.scan = (int*)p; p += NWARP * 4 * 2;
  }
  s.misc = (int*)p;
  p = base + off[3];
  if (gsrc) {
    s.src = gsrc;
  } else {
    s.src = (int16_t*)p; p += (size_t)N * ES * 2;
  }
  s.order = (int16_t*)p; p += N * 2;
  s.rank_of = (int16_t*)p; p += N * 2;
  s.path = s.bstart = (int16_t*)p; p += N * 2;
  if (!BAND) s.found = (int16_t*)p;
  p = base + off[4];
  s.base = (uint8_t*)p; p += N;
  s.seq = (uint8_t*)p; p += ML;
  s.has_out = (uint8_t*)p; p += N;
  if (!BAND) {
    s.step = (uint8_t*)p; p += N;
  }
  s.far = (uint8_t*)p;
  s.left = nullptr;
  return s;
}

// The global build's carve: the phase cycles, reductions, scan buffers and
// misc in shared memory (GLOBAL_SHARED bytes), everything else in the
// window's global scratch (poa_common::carve_graph), the band starts and
// step codes in arrays of their own.
template <typename IdT>
__device__ inline ShT<IdT> carve_global(char* base, char* g, int N, int ML,
                                        IdT* gsrc) {
  using namespace poa_common;
  ShT<IdT> s;
  char* p = base;
  s.ph = (long long*)p; p += NPHASE * 8;
  s.red_v = (int*)p; p += NWARP * 4;
  s.red_i = (int*)p; p += NWARP * 4;
  s.red_w = (int*)p; p += NWARP * 4;
  s.scan = (int*)p; p += NWARP * 4 * 2;
  s.misc = (int*)p;
  carve_graph(s, g, N, ML, gsrc);
  size_t off[G_END + 1];
  graph_layout(N, ML, off);
  s.bstart = (IdT*)(g + off[G_BSTART]);
  s.step = (uint8_t*)(g + off[G_STEP]);
  return s;
}

struct Win {
  int* H;       // [N + 1][ML + 1]
  int* ew;      // [N][ES] in-edge weights
  uint8_t* MV;  // [N + 1][ML + 1] move records
};

// One DP row of the flat build, rank r (node order[r]), over columns
// [0, L], its moves and its end score, by a group of threads: gt is the
// thread's index in the group, wb the group's first warp; the thread takes
// columns [gt * CH, gt * CH + CH). Every thread of the block calls it the
// same number of times (two block barriers). The row goes to the ring, and
// to the global H where a later row reads it from there (far[r]) or where
// all_global (the traceback may re-derive moves from H).
template <int CHM>
__device__ __forceinline__ void dp_row(const Shared& s, const Cfg& c,
                                       const Win& w, int r, int r_lo,
                                       int r_hi, int L, int CH, int gt,
                                       int wb, bool all_global) {
  const int HS = c.ML + 1, gp = c.gp;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int j0 = gt * CH;
  const int u = s.order[r];
  const int ub = s.base[u];
  int P[CHM + 1], S[CHM + 1];
  int jc[CHM + 1];  // the predecessor columns this thread reads, clamped
#pragma unroll
  for (int k = 0; k <= CHM; ++k) {
    P[k] = NEG_;
    S[k] = VSLOT;
    jc[k] = min(max(j0 - 1 + k, 0), L);
  }
  bool any = false, stale = false;
  // the in-edge slots four at a time; slots fill from 0
  for (int e0 = 0; e0 < c.E; e0 += 4) {
    const uint2 q = *(const uint2*)(s.src + (size_t)u * c.ES + e0);
    const int sv[4] = {(int)(int16_t)(q.x & 0xffffu), (int)(int16_t)(q.x >> 16),
                       (int)(int16_t)(q.y & 0xffffu), (int)(int16_t)(q.y >> 16)};
    if (sv[0] < 0) break;
    int rk[4];
    bool use[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      rk[t] = sv[t] >= 0 ? s.rank_of[sv[t]] : -1;
      const bool in = sv[t] >= 0 && rk[t] >= r_lo && rk[t] < r_hi;
      any |= in;
      stale |= in && rk[t] >= r;            // row not computed: all NEG
      if (in && gt == 0) s.has_out[sv[t]] = 1;
      use[t] = in && rk[t] < r;
    }
    // each predecessor row (a uniform branch): from the ring where near,
    // else from the global H; the first slot attaining the max wins
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!use[t]) continue;
      int v[CHM + 1];
      if (r - rk[t] < c.ring) {
        const int* rr = s.ring + (rk[t] & (c.ring - 1)) * HS;
#pragma unroll
        for (int k = 0; k <= CHM; ++k) v[k] = rr[jc[k]];
      } else {
        const int* hr = w.H + (size_t)(sv[t] + 1) * HS;
#pragma unroll
        for (int k = 0; k <= CHM; ++k) v[k] = hr[jc[k]];
      }
#pragma unroll
      for (int k = 0; k <= CHM; ++k)
        if (v[k] > P[k]) { P[k] = v[k]; S[k] = e0 + t; }
    }
    if (sv[3] < 0) break;
  }
  if (!any) {
#pragma unroll
    for (int k = 0; k <= CHM; ++k) {
      P[k] = (j0 - 1 + k) * gp;
      S[k] = VSLOT;
    }
  }
  int x[CHM], V[CHM], m[CHM];
  int run = INT_MIN;
#pragma unroll
  for (int k = 0; k < CHM; ++k) {
    const int j = j0 + k;
    int v = INT_MIN;
    V[k] = INT_MIN;
    m[k] = 2;
    if (k < CH && j <= L) {
      v = P[k + 1] + gp;
      m[k] = 1 | (S[k + 1] << 2);
      if (j >= 1) {
        const int diag = P[k] + (s.seq[j - 1] == ub ? c.ma : c.mm);
        if (diag >= v) { v = diag; m[k] = S[k] << 2; }
      }
      V[k] = v;
      v -= j * gp;
    }
    run = max(run, v);
    x[k] = run;
  }
  // the group's inclusive max-scan of the thread totals
  int tot = run;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, tot, d);
    if (lane >= d) tot = max(tot, o);
  }
  if (lane == 31) s.red_v[wid] = tot;
  int excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = INT_MIN;
  __syncthreads();
  for (int q = wb; q < wid; ++q) excl = max(excl, s.red_v[q]);
  int* hrow = w.H + (size_t)(u + 1) * HS;
  const bool global = all_global || s.far[r];
  int* rrow = s.ring + (size_t)(r & (c.ring - 1)) * HS;
  uint8_t* mrow = w.MV + (size_t)(u + 1) * HS;
#pragma unroll
  for (int k = 0; k < CHM; ++k) {
    const int j = j0 + k;
    if (k < CH && j <= L) {
      const int row = max(x[k], excl) + j * gp;
      if (global) hrow[j] = row;
      rrow[j] = row;
      // left only if better
      mrow[j] = (uint8_t)(stale ? MV_REDERIVE : row > V[k] ? 2 : m[k]);
      if (j == L) s.esc[r] = row;
    }
  }
  __syncthreads();
}

// dp_row with the thread's columns unrolled to the next of 2, 4, 8 (and in
// the wide build, CX = CHWIDE, 16) at or above CH (a uniform branch): a DP
// row's instructions are what bounds it once two windows share an SM, and
// a column beyond CH costs as much as one within.
template <int CX>
__device__ __forceinline__ void dp_row_ch(const Shared& s, const Cfg& c,
                                          const Win& w, int r, int r_lo,
                                          int r_hi, int L, int CH, int gt,
                                          int wb, bool all_global) {
  if (CH <= 2)
    dp_row<2>(s, c, w, r, r_lo, r_hi, L, CH, gt, wb, all_global);
  else if (CH <= 4)
    dp_row<4>(s, c, w, r, r_lo, r_hi, L, CH, gt, wb, all_global);
  else if (CX == CHMAX || CH <= CHMAX)
    dp_row<CHMAX>(s, c, w, r, r_lo, r_hi, L, CH, gt, wb, all_global);
  else
    dp_row<CX>(s, c, w, r, r_lo, r_hi, L, CH, gt, wb, all_global);
}

// The banded build's layer DP: every row of ranks [r_lo, r_hi) in rank
// order, its cells, move records and end score, by the whole block, one
// barrier a row. Each thread owns columns [tid * CH, tid * CH + CH) of
// every row; CHM >= CH is how many it unrolls. Row r reads its descriptor
// (desc[r]) and, with a half band hw > 0, its band start (bstart[r]);
// column 0's diagonal is then NEG + mismatch and, after the gap pass, the
// cells outside [bstart, bstart + 2 hw] become NEG. The cells and records
// are dp_row's: a cell records the move of the larger of its diagonal and
// up values (diagonal on ties, through the first slot that attains the
// predecessor maximum) unless the row's value there beats it (left). The
// row just finished is read from registers, older rows from the ring or,
// where far[rk] marks them, the global H. all_global: every row goes to
// the global H too (the traceback re-derives some moves from H).
template <int CHM>
__device__ __forceinline__ void dp_layer_band(const Shared& s, const Cfg& c,
                                              const Win& w, int r_lo,
                                              int r_hi, int L, int CH,
                                              bool all_global, int hw) {
  const int HS = c.ML + 1, gp = c.gp;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const bool banded = hw > 0;
  const unsigned w2 = 2u * (unsigned)hw;  // in band: j - bstart in [0, w2]
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
  for (int r = r_lo; r < r_hi; ++r) {
    const int u = s.order[r];
    const int ub = s.base[u];
    const int b0 = banded ? s.bstart[r] : 0;
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
    // in-subgraph predecessors, NEG at least, and the first slot that
    // exceeds NEG with it (P, S)
    int P[CHM + 1], S[CHM + 1];
#pragma unroll
    for (int k = 0; k <= CHM; ++k) {
      P[k] = NEG_;
      S[k] = VSLOT;
    }
    const unsigned long long dsc = s.desc[r];
    const bool stale = dsc & D_STALE;
    auto take = [&](int sv, int rk, int slot) {
      int v[CHM + 1];
      pred_row(sv, rk, v);
#pragma unroll
      for (int k = 0; k <= CHM; ++k)
        if (v[k] > P[k]) { P[k] = v[k]; S[k] = slot; }
    };
    if (!(dsc & D_SLOW)) {  // the computed predecessors, in slot order
      const int np = (int)(dsc & 3);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (i < np) {
          const int ent = (int)(dsc >> (D_ENT + 16 * i)) & 0xffff;
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
    if (!(dsc & D_ANY)) {  // the virtual start row is the only predecessor
#pragma unroll
      for (int k = 0; k <= CHM; ++k) P[k] = (j0 - 1 + k) * gp;
    }
    // each cell's diagonal-or-up value V and its move (a byte of mq), then
    // the running max of V - j gap
    int x[CHM], V[CHM];
    unsigned mq[(CHM + 3) / 4];
#pragma unroll
    for (int q = 0; q < (CHM + 3) / 4; ++q) mq[q] = 0;
    int run = INT_MIN;
#pragma unroll
    for (int k = 0; k < CHM; ++k) {
      const int j = j0 + k;
      int v = INT_MIN, mk = 2;
      V[k] = INT_MIN;
      if (k < CH && j <= L) {
        v = P[k + 1] + gp;
        mk = 1 | S[k + 1] << 2;
        if (j >= 1) {
          const int diag = P[k] + (code[k] == ub ? c.ma : c.mm);
          if (diag >= v) { v = diag; mk = S[k] << 2; }
        } else if (banded && NEG_ + c.mm >= v) {
          v = NEG_ + c.mm;
          mk = VSLOT << 2;
        }
        V[k] = v;
        v -= j * gp;
      }
      mq[k >> 2] |= (unsigned)mk << (8 * (k & 3));
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
        if (banded && (unsigned)(j - b0) > w2) row = NEG_;
        prow[k] = row;
        if (global) hrow[j] = row;
        rrow[j] = row;
        // left only if better
        const int mk = (mq[k >> 2] >> (8 * (k & 3))) & 0xff;
        mrow[j] = (uint8_t)(stale ? MV_REDERIVE : row > V[k] ? 2 : mk);
        if (j == L) s.esc[r] = row;
      }
    }
    // column j0 - 1 of this row: its running max there, this thread's
    // exclusive scan value, masked as the row is (thread 0 reads its own
    // column 0 instead)
    if (j0 >= 1)
      pleft = banded && (unsigned)(j0 - 1 - b0) > w2 ? NEG_
                                                    : excl + (j0 - 1) * gp;
  }
  __syncthreads();
}

// dp_layer_band with the thread's columns unrolled to the next of 2, 4, 8
// (and in the wide build, CX = CHWIDE, 16) at or above CH.
template <int CX>
__device__ __forceinline__ void dp_layer_band_ch(const Shared& s,
                                                 const Cfg& c, const Win& w,
                                                 int r_lo, int r_hi, int L,
                                                 bool all_global, int hw) {
  const int CH = (L + 1 + NT - 1) / NT;
  if (CH <= 2)
    dp_layer_band<2>(s, c, w, r_lo, r_hi, L, CH, all_global, hw);
  else if (CH <= 4)
    dp_layer_band<4>(s, c, w, r_lo, r_hi, L, CH, all_global, hw);
  else if (CX == CHMAX || CH <= CHMAX)
    dp_layer_band<CHMAX>(s, c, w, r_lo, r_hi, L, CH, all_global, hw);
  else
    dp_layer_band<CX>(s, c, w, r_lo, r_hi, L, CH, all_global, hw);
}

// The global build's layer DP: dp_layer_band's rows, cells, move records
// and end scores (hw 0: the flat DP), with each row's columns [0, L] in
// tiles of TW (tile t, thread tid: columns t * TW + tid * CHMAX + k), so
// max_len has no limit. A tile's scan starts from the running max of the
// tiles before it (carry); one barrier a tile, the warp totals alternating
// between two buffers. Every row goes to the global H, and every
// predecessor row is read from there: a thread's own columns of the row
// just finished are cells it wrote itself, and the cell left of its first
// column is that row's running max there, which it kept in left[t][tid]
// (masked as the row was).
template <class Sh>
__device__ void dp_layer_tiled(const Sh& s, const Cfg& c, const Win& w,
                               int r_lo, int r_hi, int L, int hw) {
  constexpr int CHM = CHMAX;
  const int HS = c.ML + 1, gp = c.gp;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const bool banded = hw > 0;
  const unsigned w2 = 2u * (unsigned)hw;  // in band: j - bstart in [0, w2]
  const int ntile = (L + TW) / TW;
  int par = 0;      // the tile's half of the scan's double buffer
  for (int r = r_lo; r < r_hi; ++r) {
    const int u = s.order[r];
    const int ub = s.base[u];
    const int b0 = banded ? s.bstart[r] : 0;
    const unsigned long long dsc = s.desc[r];
    const bool stale = dsc & D_STALE;
    int* hrow = w.H + (size_t)(u + 1) * HS;
    uint8_t* mrow = w.MV + (size_t)(u + 1) * HS;
    int carry = INT_MIN;  // the row's running max before the tile
    for (int t = 0; t < ntile; ++t) {
      const int j0 = t * TW + tid * CHM;
      int* lft = s.left + t * NT + tid;
      int jc[CHM + 1];
#pragma unroll
      for (int k = 0; k <= CHM; ++k) jc[k] = min(max(j0 - 1 + k, 0), L);
      // one predecessor row at the thread's columns jc, from the global H
      // (sv < 0: the node is order[rk])
      auto pred_row = [&](int sv, int rk, int* v) {
        const int node = sv >= 0 ? sv : s.order[rk];
        const int* hr = w.H + (size_t)(node + 1) * HS;
#pragma unroll
        for (int k = 0; k <= CHM; ++k) v[k] = hr[jc[k]];
        if (r - rk == 1 && j0 >= 1) v[0] = *lft;
      };
      int P[CHM + 1], S[CHM + 1];
#pragma unroll
      for (int k = 0; k <= CHM; ++k) {
        P[k] = NEG_;
        S[k] = VSLOT;
      }
      auto take = [&](int sv, int rk, int slot) {
        int v[CHM + 1];
        pred_row(sv, rk, v);
#pragma unroll
        for (int k = 0; k <= CHM; ++k)
          if (v[k] > P[k]) { P[k] = v[k]; S[k] = slot; }
      };
      if (!(dsc & D_SLOW)) {
        const int np = (int)(dsc & 3);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (i < np) {
            const int ent = (int)(dsc >> (D_ENT + 16 * i)) & 0xffff;
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
      if (!(dsc & D_ANY)) {
#pragma unroll
        for (int k = 0; k <= CHM; ++k) P[k] = (j0 - 1 + k) * gp;
      }
      int x[CHM], V[CHM];
      unsigned mq[(CHM + 3) / 4];
#pragma unroll
      for (int q = 0; q < (CHM + 3) / 4; ++q) mq[q] = 0;
      int run = INT_MIN;
#pragma unroll
      for (int k = 0; k < CHM; ++k) {
        const int j = j0 + k;
        int v = INT_MIN, mk = 2;
        V[k] = INT_MIN;
        if (j <= L) {
          v = P[k + 1] + gp;
          mk = 1 | S[k + 1] << 2;
          if (j >= 1) {
            const int diag = P[k] + (s.seq[j - 1] == ub ? c.ma : c.mm);
            if (diag >= v) { v = diag; mk = S[k] << 2; }
          } else if (banded && NEG_ + c.mm >= v) {
            v = NEG_ + c.mm;
            mk = VSLOT << 2;
          }
          V[k] = v;
          v -= j * gp;
        }
        mq[k >> 2] |= (unsigned)mk << (8 * (k & 3));
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
          if (banded && (unsigned)(j - b0) > w2) row = NEG_;
          hrow[j] = row;
          // left only if better
          const int mk = (mq[k >> 2] >> (8 * (k & 3))) & 0xff;
          mrow[j] = (uint8_t)(stale ? MV_REDERIVE : row > V[k] ? 2 : mk);
          if (j == L) s.esc[r] = row;
        }
      }
      if (j0 >= 1 && j0 - 1 <= L)
        *lft = banded && (unsigned)(j0 - 1 - b0) > w2 ? NEG_
                                                      : excl + (j0 - 1) * gp;
    }
  }
  __syncthreads();
}

// Whether node a is among node b's in-edge sources.
__device__ __forceinline__ bool has_src(const Shared& s, const Cfg& c, int b,
                                        int a) {
  for (int e = 0; e < c.E; ++e) {
    const int sv = s.src[(size_t)b * c.ES + e];
    if (sv < 0) return false;
    if (sv == a) return true;
  }
  return false;
}

// The plain version's move at (u, j), re-derived from the finished rows of
// H: diagonal before up, each through the first slot whose row attains the
// cell, else left. *next gets the predecessor, -1 for the virtual row.
template <class Sh>
__device__ int rederive(const Sh& s, const Cfg& c, const Win& w, int u,
                        int j, int r_lo, int r_hi, int* next) {
  const int HS = c.ML + 1;
  const int cur = w.H[(size_t)(u + 1) * HS + j];
  const int jm1 = max(j - 1, 0);
  const int sc = s.seq[jm1] == s.base[u] ? c.ma : c.mm;
  int diag = -2, up = -2;  // -2: no such move
  bool any = false;
  for (int e = 0; e < c.E; ++e) {
    const int sv = s.src[(size_t)u * c.ES + e];
    if (sv < 0) break;
    const int rk = s.rank_of[sv];
    if (rk < r_lo || rk >= r_hi) continue;
    any = true;
    const int* hr = w.H + (size_t)(sv + 1) * HS;
    if (diag == -2 && j > 0 && hr[jm1] + sc == cur) diag = sv;
    if (up == -2 && hr[j] + c.gp == cur) up = sv;
  }
  if (!any) {
    if (j > 0 && jm1 * c.gp + sc == cur) diag = -1;
    if (j * c.gp + c.gp == cur) up = -1;
  }
  if (diag != -2) { *next = diag; return 0; }
  if (up != -2) { *next = up; return 1; }
  return 2;
}

// Traceback state: the cell (u, j), steps taken, the insertion run and
// next matched key being written, whether the walk ran off column 0, and
// (banded build) whether it came within one cell of the band edge.
struct Walk {
  int u, j, tb, run;
  float nk;
  bool off, hit;
};

// One traceback step from cell (u, j) whose move byte is mv (every lane of
// warp 0 the same; lane 0 writes the position records). Returns the lane
// of traceback()'s fetch that holds the next cell's move byte, or -1 where
// none does (a re-derived move, or the virtual row).
template <bool BAND, class Sh>
__device__ __forceinline__ int tb_step(const Sh& s, const Cfg& c,
                                       const Win& w, Walk& k, int mv,
                                       int r_lo, int r_hi, int lane, int hw,
                                       int begin) {
  ++k.tb;
  if (BAND && hw > 0 &&
      abs(k.j - ((int)(s.key[k.u] + 0.5f) - begin)) >= hw - 1)
    k.hit = true;
  int move = mv & 3, nxt = -1, at = -1;
  const int sl = mv >> 2;
  if (move == MV_REDERIVE) {
    move = rederive(s, c, w, k.u, k.j, r_lo, r_hi, &nxt);
    at = move == 2 ? 30 : -1;
  } else if (move < 2 && sl != VSLOT) {
    nxt = s.src[(size_t)k.u * c.ES + sl];
    at = move == 0 ? sl : 15 + sl;
  } else if (move == 2) {
    at = 30;
  }
  if (move == 0) {           // diagonal: position j-1 matches u
    if (BAND && k.j == 0) {  // the banded DP's diagonal off column 0
      k.off = true;
      return -1;
    }
    k.nk = s.key[k.u]; k.run = 0;
    --k.j;
    if (lane == 0) { s.nkey[k.j] = k.nk; s.runrem[k.j] = 0; }
    k.u = nxt;
  } else if (move == 1) {    // up
    k.u = nxt;
  } else {                   // left: position j-1 is inserted
    --k.j;
    if (k.j < 0) { k.off = true; return -1; }
    ++k.run;
    if (lane == 0) { s.nkey[k.j] = k.nk; s.runrem[k.j] = k.run; }
  }
  return k.u < 0 ? -1 : at;
}

// The traceback along the move records, by warp 0, from the end node
// start_u at column L. It writes each position's next matched key and
// remaining run as it descends; an empty subgraph fails the layer as the
// plain version's walk from node 0's empty row does. Two steps per trip to
// global memory: the lanes fetch the move byte of the cell (u, j) (lane
// 31) together with those of every cell a move from it can reach (lane e:
// the diagonal through slot e, lane 15 + e: up through slot e, lane 30:
// left), so the step after the next needs no other load.
template <bool BAND, class Sh>
__device__ void traceback(const Sh& s, const Cfg& c, const Win& w,
                          int start_u, int L, int n_sub, int r_lo,
                          int r_hi, int hw, int begin) {
  const int HS = c.ML + 1, lane = threadIdx.x & 31;
  const int limit = c.N + c.ML + 2;
  Walk k{start_u, L, 0, c.ML - L, INFINITY, false, false};
  while (n_sub > 0 && !(k.u == -1 && k.j == 0) && k.tb < limit) {
    if (k.u == -1) {             // virtual row: only left moves
      ++k.tb;
      --k.j;
      ++k.run;
      if (lane == 0) { s.nkey[k.j] = k.nk; s.runrem[k.j] = k.run; }
      continue;
    }
    const int e = lane < 15 ? lane : lane - 15;
    const int sv = lane < 30 && e < c.E ? s.src[(size_t)k.u * c.ES + e] : -1;
    const uint8_t* mrow = w.MV + (size_t)(k.u + 1) * HS;
    int got = 0;
    if (lane == 31)
      got = mrow[k.j];
    else if (lane == 30)
      got = k.j > 0 ? mrow[k.j - 1] : 0;
    else if (sv >= 0 && (lane >= 15 || k.j > 0))
      got = w.MV[(size_t)(sv + 1) * HS + k.j - (lane < 15)];
    const int at = tb_step<BAND>(s, c, w, k,
                                 __shfl_sync(0xffffffffu, got, 31), r_lo,
                                 r_hi, lane, hw, begin);
    const int mv2 = __shfl_sync(0xffffffffu, got, at < 0 ? 0 : at);
    if (k.off) break;
    if (at < 0 || (k.u == -1 && k.j == 0) || k.tb >= limit) continue;
    tb_step<BAND>(s, c, w, k, mv2, r_lo, r_hi, lane, hw, begin);
    if (k.off) break;
  }
  if (lane == 0) {
    if (!(k.u == -1 && k.j == 0)) s.misc[1] = 1;
    if (BAND && k.hit) s.misc[6] = 1;
    for (int jj = k.j - 1; jj >= 0; --jj) {  // positions the walk missed
      s.nkey[jj] = k.nk; s.runrem[jj] = ++k.run;
    }
  }
}

// GSRC: the in-edge sources live in the window's global scratch (where the
// graph is too large to keep them in shared memory). BAND: the banded
// build, which takes each window's half band (wband_a; 0 runs the flat DP)
// and writes its band hit (band_hit_out): dp_layer_band's rows and mask,
// the deficit test after the end pick, and tb_step's boundary test. CX:
// the most columns a thread owns, CHMAX or, in the wide build, CHWIDE;
// CHGLOBAL is the global build (the graph in the global scratch, the
// banded build's rows in tiles; GSRC), flat (BAND false: wband 0, colstep's
// steps counted) or banded. IdT: the node ids' type, int32 only in the
// global build above INT16_NODES node slots (poa_common::wide_ids).
template <bool GSRC, bool BAND, int CX, typename IdT = int16_t>
__global__ void __launch_bounds__(NT, CX == CHWIDE ? 1 : 2)
poa_v2_kernel(Cfg c, const uint8_t* __restrict__ bb,
              const int* __restrict__ bbw, const int* __restrict__ bb_len_a,
              const int* __restrict__ n_layers_a,
              const uint8_t* __restrict__ seqs, const int* __restrict__ ws,
              const int* __restrict__ lens, const int* __restrict__ begins,
              const int* __restrict__ ends, const int* __restrict__ wband_a,
              int* __restrict__ cons_base,
              int* __restrict__ cons_cov, int* __restrict__ cons_len,
              uint8_t* __restrict__ failed_out, int* __restrict__ n_nodes,
              uint8_t* __restrict__ band_hit_out,
              long long* __restrict__ cells, long long* __restrict__ steps,
              long long* __restrict__ phases, int* __restrict__ scratch,
              size_t scratch_per) {
  extern __shared__ __align__(16) char smem[];
  const int N = c.N, ML = c.ML, E = c.E, ES = c.ES;
  const int HS = ML + 1;
  const int win = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
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
      return carve<BAND>(smem, N, ML, ES, c.ring,
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
  long long dp_cells = 0, dp_steps = 0;
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
    for (int j = tid; j < ML; j += NT) {
      s.seq[j] = j < L ? sq[j] : 0;
      if (!BAND) s.wts[j] = j < L ? wq[j] : 0;  // BAND: in the update
    }
    for (int r = tid; r < n; r += NT) {
      s.rank_of[s.order[r]] = (IdT)r;
      s.has_out[r] = 0;
      s.far[r] = 0;
    }
    if (tid == 0) {
      s.misc[2] = count_keys(s, n, lo, false);  // r_lo
      s.misc[3] = count_keys(s, n, hi, true);   // r_hi, within [0, n)
      s.misc[5] = 0;                            // band cells
      if (GLB) s.misc[7] = 0;                   // colstep pairs
    }
    __syncthreads();
    const int r_lo = s.misc[2], r_hi = s.misc[3];
    const int n_sub = r_hi - r_lo;
    const bool banded = BAND && hw > 0;
    if constexpr (BAND || GLB) {
      // Before the banded DP, in parallel: each row's descriptor (D_*) and
      // band start, the nodes with an out-edge inside the subgraph, the
      // rows that a row c.ring or more ranks later reads (from the global
      // H), whether some row has an in-subgraph predecessor not computed
      // before it (then every row goes to the global H, for the
      // traceback's re-derivation), and the band's cells. The flat global
      // build also counts colstep's pairs (ranks that start one, as the
      // flat build's step codes find them), for its serial steps.
      int late = 0, band_cells = 0, pairs = 0;
      for (int r = r_lo + tid; r < r_hi; r += NT) {
        const int u0 = s.order[r];
        if (GLB && !BAND && c.colstep && r + 1 < r_hi) {
          const float k = s.key[u0];
          pairs += s.key[s.order[r + 1]] == k &&
                   ((r - max(r_lo, count_keys(s, n, k, false))) & 1) == 0;
        }
        if (banded) {  // the columns of [0, L] the row's band admits
          const int ce = (int)(s.key[u0] + 0.5f) - begin;
          band_cells += max(0, min(L, ce + hw) - max(0, ce - hw) + 1);
          s.bstart[r] = sizeof(IdT) == 2
                            ? (IdT)max(ce - min(hw, 16384), -32768)
                            : (IdT)(ce - hw);
        }
        unsigned long long dsc = 0;
        int np = 0;
        for (int e = 0; e < E; ++e) {
          const int sv = s.src[(size_t)u0 * ES + e];
          if (sv < 0) break;
          const int rk = s.rank_of[sv];
          if (rk < r_lo || rk >= r_hi) continue;
          s.has_out[sv] = 1;
          dsc |= D_ANY;
          if (rk >= r) {
            late = 1;
            dsc |= D_STALE;
            continue;
          }
          const int d = r - rk;
          if (d >= c.ring) s.far[rk] = 1;
          if (np < 3 && d < 4096)
            dsc |= (unsigned long long)(d | e << 12) << (D_ENT + 16 * np++);
          else
            dsc |= D_SLOW;
        }
        s.desc[r] = dsc | np;
      }
      if (banded) atomicAdd(&s.misc[5], band_cells);
      if (GLB && pairs) atomicAdd(&s.misc[7], pairs);
      const bool all_global = __syncthreads_or(late);
      dp_cells += banded ? (long long)atomicAdd(&s.misc[5], 0)
                         : (long long)n_sub * (L + 1);
      dp_steps += n_sub - (GLB ? atomicAdd(&s.misc[7], 0) : 0);
      PHASE(0);
      if constexpr (GLB)
        dp_layer_tiled(s, c, w, r_lo, r_hi, L, banded ? hw : 0);
      else
        dp_layer_band_ch<CX>(s, c, w, r_lo, r_hi, L, all_global,
                             banded ? hw : 0);
      PHASE(1);
    } else {
      PHASE(0);

      // --- DP over the subgraph in rank order, a same-column pair per
      // step with colstep. The pairs are ops/colstep.pair_schedule's: rank
      // r starts one where rank r + 1 has its key and r is an even distance
      // from the first rank of that key in the subgraph. Each rank's step
      // code, found in parallel: 0 one row; 1 a pair whose first node is
      // among the second's in-edges, or whose half-row exceeds the build's
      // CX columns a thread, the rows one after the other; 2 a pair run on
      // the two halves of the block at once.
      const int CH = (L + 1 + NT - 1) / NT;
      const int CHh = (L + 1 + HALF - 1) / HALF;
      // The same pass marks each row that a row c.ring or more ranks later
      // reads (from the global H), and finds whether some row has an
      // in-subgraph predecessor not computed before it (then every row
      // goes to the global H, for the traceback's re-derivation).
      int late = 0;
      for (int r = r_lo + tid; r < r_hi; r += NT) {
        const int u0 = s.order[r];
        int code = 0;
        if (c.colstep && r + 1 < r_hi) {
          const int u1 = s.order[r + 1];
          const float k = s.key[u0];
          if (s.key[u1] == k &&
              ((r - max(r_lo, count_keys(s, n, k, false))) & 1) == 0)
            code = CHh <= CX && !has_src(s, c, u1, u0) ? 2 : 1;
        }
        s.step[r] = (uint8_t)code;
        for (int e = 0; e < E; ++e) {
          const int sv = s.src[(size_t)u0 * ES + e];
          if (sv < 0) break;
          const int rk = s.rank_of[sv];
          if (rk < r_lo || rk >= r_hi) continue;
          if (rk >= r) late = 1;
          else if (r - rk >= c.ring) s.far[rk] = 1;
        }
      }
      const bool all_global = __syncthreads_or(late);
      dp_cells += (long long)n_sub * (L + 1);
      for (int r = r_lo; r < r_hi; ++dp_steps) {
        const int code = s.step[r];
        if (code == 2) {
          const int h = tid / HALF;
          dp_row_ch<CX>(s, c, w, r + h, r_lo, r_hi, L, CHh, tid % HALF,
                        h * (NWARP / 2), all_global);
        } else {
          dp_row_ch<CX>(s, c, w, r, r_lo, r_hi, L, CH, tid, 0, all_global);
          if (code == 1)
            dp_row_ch<CX>(s, c, w, r + 1, r_lo, r_hi, L, CH, tid, 0,
                          all_global);
        }
        r += code ? 2 : 1;
      }
      PHASE(1);
    }

    // --- end node: first best end score in rank order among subgraph
    // nodes with no out-edge inside the subgraph
    int ba = INT_MIN, bbv = 0, bi = -1;
    for (int r = r_lo + tid; r < r_hi; r += NT) {
      const int sc = s.has_out[s.order[r]] ? NEG_ : s.esc[r];
      if (bi < 0 || better(sc, 0, r, ba, bbv, bi)) { ba = sc; bi = r; }
    }
    block_best(red, ba, bbv, bi);
    int start_u = bi >= 0 ? s.order[bi] : 0;
    if (banded) {
      // the deficit test; an end score no better than NEG starts the walk
      // on the virtual row, as the Pallas kernel's end pick does
      const int best_s = bi >= 0 ? max(ba, NEG_) : NEG_;
      if (tid == 0 && c.ma * L - best_s > 2 * (-c.gp) * max(hw / 2, 1))
        s.misc[6] = 1;
      if (bi >= 0 && ba <= NEG_) start_u = -1;
    }
    PHASE(2);

    // --- traceback along the move records (warp 0)
    if (wid == 0)
      traceback<BAND>(s, c, w, start_u, L, n_sub, r_lo, r_hi, hw, begin);
    __syncthreads();
    PHASE(3);

    // --- graph update. Each matched position's node among the n old
    // nodes, one thread per position, in the frozen order.
    for (int jj = tid; jj < L; jj += NT) {
      if (BAND) s.wts[jj] = wq[jj];  // in the ring's bytes: loaded here
      s.found[jj] = (IdT)(s.runrem[jj] == 0
                              ? find_old(s, n, s.nkey[jj], s.seq[jj])
                              : -1);
    }
    __syncthreads();
    if (wid == 0) {                // the walk (warp 0)
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
        const bool overflow = found < 0 && nn >= N;
        int nid;
        float nid_key;               // the next position's prev_key
        if (found >= 0) {
          nid = found;
          nid_key = s.key[nid];
        } else {
          nid = min(nn, N - 1);
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
          // edge prev -> nid, weight w[j-1] + w[j]
          if (prev >= 0 && !poa_common::add_edge(s.src, w.ew, E, ES, nid,
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
    __syncthreads();
    if (s.misc[0] > n) merge_new(s, n, s.misc[0]);
    PHASE(4);
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
    if (steps) steps[win] = dp_steps;
  }
  PHASE(5);
  if (phases && tid == 0)
    for (int k = 0; k < NPHASE; ++k)
      phases[(size_t)k * gridDim.x + win] = s.ph[k];
#undef PHASE
}

// The launch's plan (poa_common::plan) for this kernel's layout, the flat
// build's or (band) the banded build's.
cudaError_t plan(int N, int ML, int ES, bool band, int* ring, bool* gsrc,
                 bool* glob, size_t* sm) {
  return poa_common::plan(N, ML, ES, RING,
                          band ? shared_bytes<true> : shared_bytes<false>,
                          ring, gsrc, glob, sm);
}

using Kernel = decltype(&poa_v2_kernel<false, false, CHMAX>);

// The kernel instantiation a plan launches (the banded build where band;
// the global build where glob, with int32 node ids where ids32, else the
// wide one where wide, which the plan gives gsrc), with its shared-memory
// limit raised to sm.
cudaError_t planned_kernel(bool gsrc, bool band, bool wide, bool glob,
                           bool ids32, size_t sm, Kernel* fn) {
  if (glob && ids32)
    *fn = band ? &poa_v2_kernel<true, true, CHGLOBAL, int32_t>
               : &poa_v2_kernel<true, false, CHGLOBAL, int32_t>;
  else if (glob)
    *fn = band ? &poa_v2_kernel<true, true, CHGLOBAL>
               : &poa_v2_kernel<true, false, CHGLOBAL>;
  else if (wide)
    *fn = band ? &poa_v2_kernel<true, true, CHWIDE>
               : &poa_v2_kernel<true, false, CHWIDE>;
  else if (gsrc)
    *fn = band ? &poa_v2_kernel<true, true, CHMAX>
               : &poa_v2_kernel<true, false, CHMAX>;
  else
    *fn = band ? &poa_v2_kernel<false, true, CHMAX>
               : &poa_v2_kernel<false, false, CHMAX>;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sm);
}

}  // namespace

extern "C" {

// Scratch int32 words per window (scratch_layout), for the global build
// where glob.
long long rt_poa_v2_scratch_words(int N, int ML, int E, int glob) {
  size_t off[5];
  scratch_layout(N, ML, edge_stride(E), glob != 0, off);
  return (long long)off[4];
}

// The plan at (N, ML, E) of the flat build or (band) the banded build:
// out[0] the ring's rows, out[1] 1 where the in-edge sources are in shared
// memory, out[2] the dynamic shared bytes a block, out[3] 1 for the global
// build.
int rt_poa_v2_plan(int N, int ML, int E, int band, int* out) {
  int ring = 0;
  bool gsrc = false, glob = false;
  size_t sm = 0;
  const cudaError_t err =
      plan(N, ML, edge_stride(E), band != 0, &ring, &gsrc, &glob, &sm);
  out[0] = ring;
  out[1] = gsrc ? 0 : 1;
  out[2] = (int)sm;
  out[3] = glob ? 1 : 0;
  return (int)err;
}

// The dynamic shared bytes of the flat or (band) the banded build's layout
// at (N, ML, E) with a ring of `ring` rows and the in-edge sources in the
// global scratch where gsrc: what plan holds against the card's limit, for
// the plan audit (racon_tpu_torch/analysis/build_audit.py).
long long rt_poa_v2_layout_bytes(int N, int ML, int E, int band, int ring,
                                 int gsrc) {
  const int ES = edge_stride(E);
  return (long long)(band ? shared_bytes<true>(N, ML, ES, ring, gsrc != 0)
                          : shared_bytes<false>(N, ML, ES, ring, gsrc != 0));
}

// One block per window. Inputs as rt_poa_launch (csrc/poa.cu), and wband
// i32[B] or null: each window's half band (the banded build; null runs the
// flat build); colstep pairs same-column ranks per serial step (the flat
// build only: the banded build runs one row a step). Outputs:
// cons_base, cons_cov i32[B,N], cons_len i32[B], failed u8[B], n_nodes
// i32[B], band_hit u8[B] (with wband); cells and steps i64[B] (each may be
// null): each window's DP cells (sum over its layers of subgraph nodes x
// (layer length + 1); under a half band, the columns of [0, L] each row's
// band admits) and serial DP iterations;
// phases i64[NPHASE, B] (may be null): each window's clock64() cycles in
// graph init and layer set-up, DP, end-node pick, traceback, graph update
// and consensus, as thread 0 sees them.
// scratch i32[B, rt_poa_v2_scratch_words(..., the plan's global build)].
// Node ids are int16, int32 in the global build above INT16_NODES.
int rt_poa_v2_launch(int N, int ML, int MB, int E, int D, int ma, int mm,
                     int gp, int colstep, const void* bb, const void* bbw,
                     const void* bb_len, const void* n_layers,
                     const void* seqs, const void* ws, const void* lens,
                     const void* begins, const void* ends,
                     const void* wband, void* cons_base, void* cons_cov,
                     void* cons_len, void* failed, void* n_nodes,
                     void* band_hit, void* cells, void* steps, void* phases,
                     void* scratch, int B, void* stream) {
  if (E > VSLOT) return (int)cudaErrorInvalidValue;
  const int ES = edge_stride(E);
  const bool band = wband != nullptr;
  int ring = 0;
  bool gsrc = false, glob = false;
  size_t sm = 0;
  cudaError_t err = plan(N, ML, ES, band, &ring, &gsrc, &glob, &sm);
  Kernel fn = nullptr;
  if (err == cudaSuccess)
    err = planned_kernel(gsrc, band, wide_build(ML), glob, wide_ids(N, glob),
                         sm, &fn);
  if (err != cudaSuccess) return (int)err;
  Cfg c{N, ML, MB, E, ES, D, ma, mm, gp, colstep ? 1 : 0, ring};
  const size_t per = (size_t)rt_poa_v2_scratch_words(N, ML, E, glob);
  fn<<<B, NT, sm, (cudaStream_t)stream>>>(
      c, (const uint8_t*)bb, (const int*)bbw, (const int*)bb_len,
      (const int*)n_layers, (const uint8_t*)seqs, (const int*)ws,
      (const int*)lens, (const int*)begins, (const int*)ends,
      (const int*)wband, (int*)cons_base, (int*)cons_cov, (int*)cons_len,
      (uint8_t*)failed, (int*)n_nodes, (uint8_t*)band_hit,
      (long long*)cells, (long long*)steps,
      (long long*)phases, (int*)scratch, per);
  return (int)cudaGetLastError();
}

// The kernel's registers a thread, local (spill) bytes a thread, dynamic
// shared bytes a block and resident blocks per SM at (N, ML) with 12 edge
// slots, as the launch plans them, for the flat build or (band) the banded
// one (the wide instantiation where max_len + 1 > NT * CHMAX, the global
// one where the plan says so); out[4].
int rt_poa_v2_occupancy(int N, int ML, int band, int* out) {
  int ring = 0;
  bool gsrc = false, glob = false;
  size_t sm = 0;
  cudaError_t err =
      plan(N, ML, edge_stride(12), band != 0, &ring, &gsrc, &glob, &sm);
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
