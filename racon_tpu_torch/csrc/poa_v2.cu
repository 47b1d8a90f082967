// Batched POA window consensus, second tier (poa_kernel="v2"): one thread
// block per window.
//
// Replaces the JAX package's Pallas kernel build_pallas_poa_kernel
// (racon_tpu/ops/poa_pallas.py:73). It computes what the plain version
// ops/poa.py:poa_batch_plain computes, bit for bit, as csrc/poa.cu does, but
// takes the Pallas v2 kernel's design choices, re-thought for the card:
//   * Move records. Beside each DP cell of H the DP writes one byte,
//     move | pred slot << 2 (0 diagonal, 1 up, 2 left; slot VSLOT = the
//     virtual start row), into a global scratch. The traceback is one byte
//     load per step instead of re-deriving each move from the predecessors'
//     rows of H. A move is recorded as the plain version's traceback would
//     re-derive it: diagonal before up on ties, left only if strictly
//     better, and the first predecessor slot that attains the maximum.
//   * Incremental rank order. The rank order (stable by key, ties by node
//     id) is kept sorted through the graph update: a new node's rank is a
//     binary search over the sorted keys (count of keys <= its key) and the
//     ranks behind it shift by one slot (one warp, read before write). The
//     matched-node search of the update is a binary search to the column's
//     first rank. No per-layer rebuild.
//   * End-node selection fused into the DP sweep. Each row's score at
//     column L lands in esc[rank] and every in-subgraph predecessor is
//     marked has_out as the DP enumerates it; the pick is one block
//     reduction over the subgraph's ranks (first maximum in rank order).
//   * colstep. When rank r + 1 shares rank r's column key, both rows run in
//     the same serial iteration, one after the other in rank order, so the
//     result does not depend on the pairing. The kernel counts the
//     iterations ("steps"), which the plain version counts with
//     ops/colstep.py.
//
// Layout: H, (N + 1) x (max_len + 1) int32 per window (4.7 MB at w=500),
// the move bytes (1.2 MB), the in-edge tables (src, w: E x N int32) and the
// node coverage live in a global scratch the wrapper allocates. Keys,
// bases, the rank order, rank_of, the end scores, has_out and the layer's
// sequence, weights and traceback records live in about 51 KB of dynamic
// shared memory (N=1536, max_len=768), so shared memory does not limit the
// blocks per SM below the registers' three (80 registers a thread). A DP
// row splits its L + 1 columns into contiguous chunks, one per thread; the
// linear-gap pass H[j] = j*g + cummax(V[j] - j*g) is a block scan. The
// traceback runs on one thread, the graph update on warp 0; the consensus
// is csrc/poa_common.cuh's, shared with csrc/poa.cu.
//
// What bounds it on an H100: the serial dependency chains (one DP row after
// another, two block barriers per row, the traceback, the update), not
// bytes or integer throughput; many windows run at once so that one
// window's latency hides behind the others'.
//
// A predecessor whose row is not computed yet in this layer (possible only
// where float32 keys collide along an edge and the edge's source has the
// larger node id) counts as a row of NEG in the DP, as in the plain version.
// The plain traceback then reads that predecessor's finished row, which the
// DP did not see, so such a row's cells record MV_REDERIVE and the
// traceback re-derives their moves from H as the plain version does. Float
// discipline: keys are float32 in the plain version's order of operations;
// the library is built with --fmad=false and IEEE division.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "poa_common.cuh"

#define CHMAX 8    // columns per thread: max_len + 1 <= NT * CHMAX
#define VSLOT 15   // pred slot of the virtual start row; max_edges <= 15
#define MV_REDERIVE 3  // move of a row that read an uncomputed predecessor

namespace {

using poa_common::better;
using poa_common::block_best;

struct Cfg {
  int N, ML, MB, E, D, ma, mm, gp, colstep;
};

struct Shared {
  float* key;        // [N] column key by node id
  int* base;         // [N]
  int* order;        // [N] node id by rank; [0, n) sorted by (key, id)
  int* rank_of;      // [N] rank by node id (layers); pred (consensus)
  int* esc;          // [N] end score by rank (layers); score (consensus)
  int* path;         // [N] consensus path
  float* nkey;       // [ML] next matched key at j' >= j (traceback)
  int* runrem;       // [ML] remaining insertion run; 0 marks a match
  int* seq;          // [ML]
  int* wts;          // [ML]
  int* red_v;        // [NWARP] reduction scratch
  int* red_i;        // [NWARP]
  int* red_w;        // [NWARP]
  int* misc;         // [8]: n, failed, r_lo, r_hi, path count
  uint8_t* has_out;  // [N] node has an out-edge inside the subgraph
};

__host__ __device__ inline size_t shared_bytes(int N, int ML) {
  return (size_t)N * (4 * 6 + 1) + (size_t)ML * 4 * 4 + NWARP * 4 * 3 +
         8 * 4 + 64;
}

__device__ inline Shared carve(char* p, int N, int ML) {
  Shared s;
  s.key = (float*)p; p += N * 4;
  s.base = (int*)p; p += N * 4;
  s.order = (int*)p; p += N * 4;
  s.rank_of = (int*)p; p += N * 4;
  s.esc = (int*)p; p += N * 4;
  s.path = (int*)p; p += N * 4;
  s.nkey = (float*)p; p += ML * 4;
  s.runrem = (int*)p; p += ML * 4;
  s.seq = (int*)p; p += ML * 4;
  s.wts = (int*)p; p += ML * 4;
  s.red_v = (int*)p; p += NWARP * 4;
  s.red_i = (int*)p; p += NWARP * 4;
  s.red_w = (int*)p; p += NWARP * 4;
  s.misc = (int*)p; p += 8 * 4;
  s.has_out = (uint8_t*)p; p += N;
  return s;
}

// Ranks in [0, n) whose key is < k (strict) or <= k, by binary search over
// the sorted order.
__device__ __forceinline__ int count_keys(const Shared& s, int n, float k,
                                          bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float km = s.key[s.order[mid]];
    if (km < k || (or_equal && km == k)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First node id with key == k0 and base == b, or -1 (warp 0, all lanes
// get the answer). Equal keys are adjacent in rank order, by id.
__device__ int find_node(const Shared& s, int n, float k0, int b, int lane) {
  for (int r0 = count_keys(s, n, k0, false); r0 < n; r0 += 32) {
    const int r = r0 + lane;
    const int v = r < n ? s.order[r] : -1;
    const bool same = v >= 0 && s.key[v] == k0;
    const unsigned mhit = __ballot_sync(0xffffffffu, same && s.base[v] == b);
    if (mhit) return __shfl_sync(0xffffffffu, v, __ffs(mhit) - 1);
    if (__ballot_sync(0xffffffffu, !same)) return -1;
  }
  return -1;
}

// Place node `nid` at rank p of the sorted order over [0, n): ranks
// [p, n) move up one slot (warp 0, each chunk read before it is written,
// chunks from the top down).
__device__ void insert_rank(const Shared& s, int p, int n, int nid,
                            int lane) {
  for (int top = n; top > p; top -= 32) {
    const int i = top - 1 - lane;
    const int v = i >= p ? s.order[i] : 0;
    __syncwarp();
    if (i >= p) s.order[i + 1] = v;
    __syncwarp();
  }
  if (lane == 0) s.order[p] = nid;
  __syncwarp();
}

struct Win {
  int* H;
  uint8_t* MV;
  int* src;
  int* ew;
  int* cov;
};

// One DP row: node order[r] over columns [0, L], its moves, its end score.
__device__ __forceinline__ void dp_row(const Shared& s, const Cfg& c,
                                       const Win& w, int r, int r_lo,
                                       int r_hi, int L, int CH, int j0) {
  const int HS = c.ML + 1, E = c.E, gp = c.gp;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int u = s.order[r];
  const int ub = s.base[u];
  int P[CHMAX + 1], S[CHMAX + 1];
#pragma unroll
  for (int k = 0; k <= CHMAX; ++k) { P[k] = NEG_; S[k] = VSLOT; }
  bool any = false, stale = false;
  for (int e = 0; e < E; ++e) {
    const int sv = w.src[(size_t)u * E + e];
    if (sv < 0) break;                     // slots fill from 0
    const int rk = s.rank_of[sv];
    if (rk < r_lo || rk >= r_hi) continue; // outside the subgraph
    any = true;
    if (tid == 0) s.has_out[sv] = 1;
    if (rk >= r) {                         // row not computed: all NEG
      stale = true;
      continue;
    }
    const int* hr = w.H + (size_t)(sv + 1) * HS;
#pragma unroll
    for (int k = 0; k <= CHMAX; ++k) {
      const int j = j0 - 1 + k;
      if (k <= CH && j >= 0 && j <= L) {
        const int v = hr[j];
        if (v > P[k]) { P[k] = v; S[k] = e; }  // strict: first max slot
      }
    }
  }
  if (!any) {
#pragma unroll
    for (int k = 0; k <= CHMAX; ++k) {
      P[k] = (j0 - 1 + k) * gp;
      S[k] = VSLOT;
    }
  }
  int x[CHMAX], V[CHMAX], m[CHMAX];
  int run = INT_MIN;
#pragma unroll
  for (int k = 0; k < CHMAX; ++k) {
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
  // block inclusive max-scan of the thread totals
  int tot = run;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, tot, d);
    if (lane >= d) tot = max(tot, o);
  }
  if (lane == 31) s.red_v[wid] = tot;
  int excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = INT_MIN;
  __syncthreads();
  for (int q = 0; q < wid; ++q) excl = max(excl, s.red_v[q]);
  int* hrow = w.H + (size_t)(u + 1) * HS;
  uint8_t* mrow = w.MV + (size_t)(u + 1) * HS;
#pragma unroll
  for (int k = 0; k < CHMAX; ++k) {
    const int j = j0 + k;
    if (k < CH && j <= L) {
      const int row = max(x[k], excl) + j * gp;
      hrow[j] = row;
      // left only if better
      mrow[j] = (uint8_t)(stale ? MV_REDERIVE : row > V[k] ? 2 : m[k]);
      if (j == L) s.esc[r] = row;
    }
  }
  __syncthreads();
}

// The plain version's move at (u, j), re-derived from the finished rows of
// H: diagonal before up, each through the first slot whose row attains the
// cell, else left. *next gets the predecessor, -1 for the virtual row.
__device__ int rederive(const Shared& s, const Cfg& c, const Win& w, int u,
                        int j, int r_lo, int r_hi, int* next) {
  const int HS = c.ML + 1;
  const int cur = w.H[(size_t)(u + 1) * HS + j];
  const int jm1 = max(j - 1, 0);
  const int sc = s.seq[jm1] == s.base[u] ? c.ma : c.mm;
  int diag = -2, up = -2;  // -2: no such move
  bool any = false;
  for (int e = 0; e < c.E; ++e) {
    const int sv = w.src[(size_t)u * c.E + e];
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

__global__ void __launch_bounds__(NT)
poa_v2_kernel(Cfg c, const uint8_t* __restrict__ bb,
              const int* __restrict__ bbw, const int* __restrict__ bb_len_a,
              const int* __restrict__ n_layers_a,
              const uint8_t* __restrict__ seqs, const int* __restrict__ ws,
              const int* __restrict__ lens, const int* __restrict__ begins,
              const int* __restrict__ ends, int* __restrict__ cons_base,
              int* __restrict__ cons_cov, int* __restrict__ cons_len,
              uint8_t* __restrict__ failed_out, int* __restrict__ n_nodes,
              long long* __restrict__ cells, long long* __restrict__ steps,
              int* __restrict__ scratch, size_t scratch_per) {
  extern __shared__ __align__(16) char smem[];
  const int N = c.N, ML = c.ML, E = c.E;
  const int HS = ML + 1;
  const int win = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  Shared s = carve(smem, N, ML);
  const poa_common::Red red{s.red_v, s.red_w, s.red_i};

  Win w;
  w.H = scratch + (size_t)win * scratch_per;
  w.src = w.H + (size_t)(N + 1) * HS;
  w.ew = w.src + (size_t)N * E;
  w.cov = w.ew + (size_t)N * E;
  w.MV = (uint8_t*)(w.cov + N);

  const int bb_len = bb_len_a[win];
  const uint8_t* bbp = bb + (size_t)win * c.MB;
  const int* bbwp = bbw + (size_t)win * c.MB;

  // --- graph init: backbone chain; keys 0..bb_len-1 are already sorted
  for (int i = tid; i < N; i += NT) {
    const bool used = i < bb_len;
    s.base[i] = used ? (int)bbp[i] : -1;
    s.key[i] = used ? (float)i : INFINITY;
    s.order[i] = i;
    w.cov[i] = used ? 1 : 0;
    for (int e = 0; e < E; ++e) {
      w.src[(size_t)i * E + e] = -1;
      w.ew[(size_t)i * E + e] = 0;
    }
    if (used && i > 0) {
      w.src[(size_t)i * E] = i - 1;
      w.ew[(size_t)i * E] = bbwp[i - 1] + bbwp[i];
    }
  }
  if (tid == 0) {
    s.misc[0] = bb_len;  // n
    s.misc[1] = 0;       // failed
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
      s.seq[j] = j < L ? (int)sq[j] : 0;
      s.wts[j] = j < L ? wq[j] : 0;
    }
    for (int r = tid; r < n; r += NT) {
      s.rank_of[s.order[r]] = r;
      s.has_out[r] = 0;
    }
    if (tid == 0) {
      s.misc[2] = count_keys(s, n, lo, false);  // r_lo
      s.misc[3] = count_keys(s, n, hi, true);   // r_hi, within [0, n)
    }
    __syncthreads();
    const int r_lo = s.misc[2], r_hi = s.misc[3];
    const int n_sub = r_hi - r_lo;
    dp_cells += (long long)n_sub * (L + 1);

    // --- DP over the subgraph in rank order, same-column pairs per step
    const int CH = (L + 1 + NT - 1) / NT;
    const int j0 = tid * CH;
    for (int r = r_lo; r < r_hi; ++dp_steps) {
      dp_row(s, c, w, r, r_lo, r_hi, L, CH, j0);
      if (c.colstep && r + 1 < r_hi &&
          s.key[s.order[r + 1]] == s.key[s.order[r]]) {
        dp_row(s, c, w, r + 1, r_lo, r_hi, L, CH, j0);
        r += 2;
      } else {
        r += 1;
      }
    }

    // --- end node: first best end score in rank order among subgraph
    // nodes with no out-edge inside the subgraph
    int ba = INT_MIN, bbv = 0, bi = -1;
    for (int r = r_lo + tid; r < r_hi; r += NT) {
      const int sc = s.has_out[s.order[r]] ? NEG_ : s.esc[r];
      if (bi < 0 || better(sc, 0, r, ba, bbv, bi)) { ba = sc; bi = r; }
    }
    block_best(red, ba, bbv, bi);
    const int start_u = bi >= 0 ? s.order[bi] : 0;

    if (wid == 0) {
      // --- traceback along the move records (lane 0). It writes each
      // position's next matched key and remaining run as it descends; an
      // empty subgraph fails the layer as the plain version's walk from
      // node 0's empty row does.
      if (lane == 0) {
        int u = start_u, j = L, tb = 0, run = ML - L;
        float nk = INFINITY;
        while (n_sub > 0 && !(u == -1 && j == 0) && tb < N + ML + 2) {
          ++tb;
          if (u == -1) {             // virtual row: only left moves
            --j;
            s.nkey[j] = nk; s.runrem[j] = ++run;
            continue;
          }
          const int mv = w.MV[(size_t)(u + 1) * HS + j];
          int move = mv & 3, nxt = -1;
          if (move == MV_REDERIVE)
            move = rederive(s, c, w, u, j, r_lo, r_hi, &nxt);
          else if (move < 2 && (mv >> 2) != VSLOT)
            nxt = w.src[(size_t)u * E + (mv >> 2)];
          if (move == 0) {           // diagonal: position j-1 matches u
            nk = s.key[u]; run = 0;
            --j;
            s.nkey[j] = nk; s.runrem[j] = 0;
            u = nxt;
          } else if (move == 1) {    // up
            u = nxt;
          } else {                   // left: position j-1 is inserted
            --j;
            if (j < 0) break;
            s.nkey[j] = nk; s.runrem[j] = ++run;
          }
        }
        if (!(u == -1 && j == 0)) s.misc[1] = 1;
        for (int jj = j - 1; jj >= 0; --jj) {  // positions the walk missed
          s.nkey[jj] = nk; s.runrem[jj] = ++run;
        }
      }
      __syncwarp();

      // --- graph update (warp 0)
      int nn = s.misc[0];
      int failed = s.misc[1];
      int prev = -1, prev_w = 0;
      float prev_key = -1.0f;
      for (int jj = 0; jj < L; ++jj) {
        const int b = s.seq[jj];
        const int wj = s.wts[jj];
        const float nkj = s.nkey[jj];
        const int run_j = s.runrem[jj];
        const bool is_match = run_j == 0;  // nkey[jj] is the matched key
        const int found = is_match ? find_node(s, nn, nkj, b, lane) : -1;
        const float hi2 = isfinite(nkj) ? nkj : prev_key + 1.0f;
        const float rr = (float)run_j;
        const float lo2 = prev >= 0 ? prev_key : hi2 - rr - 1.0f;
        const float k_new = lo2 + (hi2 - lo2) / (rr + 1.0f);
        const float key_val = is_match ? nkj : k_new;
        const bool overflow = found < 0 && nn >= N;
        int nid;
        if (found >= 0) {
          nid = found;
        } else {
          nid = min(nn, N - 1);
          if (!overflow) {
            insert_rank(s, count_keys(s, nn, key_val, true), nn, nid, lane);
            if (lane == 0) { s.base[nid] = b; s.key[nid] = key_val; }
            ++nn;
          }
        }
        __syncwarp();
        if (overflow) {
          failed = 1;
        } else {
          if (lane == 0) w.cov[nid] += 1;
          // edge prev -> nid, weight w[j-1] + w[j]
          if (prev >= 0 && !poa_common::add_edge(w.src, w.ew, E, nid, prev,
                                                 prev_w + wj, lane))
            failed = 1;
        }
        __syncwarp();
        prev = nid;
        prev_key = s.key[nid];
        prev_w = wj;
      }
      if (lane == 0) { s.misc[0] = nn; s.misc[1] = failed; }
    }
    __syncthreads();
  }

  // --- consensus; score in esc, pred in rank_of
  const int n = s.misc[0];
  const int cnt = poa_common::consensus(
      s.order, s.base, n, N, E, w.src, w.ew, w.cov, s.esc, s.rank_of, s.path,
      &s.misc[4], red, cons_base + (size_t)win * N,
      cons_cov + (size_t)win * N);
  if (tid == 0) {
    cons_len[win] = cnt;
    failed_out[win] = s.misc[1] ? 1 : 0;
    n_nodes[win] = n;
    if (cells) cells[win] = dp_cells;
    if (steps) steps[win] = dp_steps;
  }
}

}  // namespace

extern "C" {

// Scratch int32 words per window: H, src, w, cov, then the move bytes.
long long rt_poa_v2_scratch_words(int N, int ML, int E) {
  const long long cells = (long long)(N + 1) * (ML + 1);
  return cells + 2LL * N * E + N + (cells + 3) / 4;
}

// One block per window. Inputs as rt_poa_launch (csrc/poa.cu); colstep
// pairs same-column ranks per serial step. Outputs: cons_base, cons_cov
// i32[B,N], cons_len i32[B], failed u8[B], n_nodes i32[B]; cells and steps
// i64[B] (each may be null): each window's DP cells (sum over its layers of
// subgraph nodes x (layer length + 1)) and serial DP iterations.
// scratch i32[B, rt_poa_v2_scratch_words].
int rt_poa_v2_launch(int N, int ML, int MB, int E, int D, int ma, int mm,
                     int gp, int colstep, const void* bb, const void* bbw,
                     const void* bb_len, const void* n_layers,
                     const void* seqs, const void* ws, const void* lens,
                     const void* begins, const void* ends, void* cons_base,
                     void* cons_cov, void* cons_len, void* failed,
                     void* n_nodes, void* cells, void* steps, void* scratch,
                     int B, void* stream) {
  if (E > VSLOT || ML + 1 > NT * CHMAX) return (int)cudaErrorInvalidValue;
  Cfg c{N, ML, MB, E, D, ma, mm, gp, colstep ? 1 : 0};
  const size_t sm = shared_bytes(N, ML);
  cudaError_t err = cudaFuncSetAttribute(
      poa_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (err != cudaSuccess) return (int)err;
  const size_t per = (size_t)rt_poa_v2_scratch_words(N, ML, E);
  poa_v2_kernel<<<B, NT, sm, (cudaStream_t)stream>>>(
      c, (const uint8_t*)bb, (const int*)bbw, (const int*)bb_len,
      (const int*)n_layers, (const uint8_t*)seqs, (const int*)ws,
      (const int*)lens, (const int*)begins, (const int*)ends,
      (int*)cons_base, (int*)cons_cov, (int*)cons_len, (uint8_t*)failed,
      (int*)n_nodes, (long long*)cells, (long long*)steps, (int*)scratch,
      per);
  return (int)cudaGetLastError();
}

}  // extern "C"
