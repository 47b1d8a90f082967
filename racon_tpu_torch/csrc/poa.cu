// Batched POA window consensus: one thread block per window.
//
// Replaces the JAX package's lane-lockstep Pallas kernel
// build_lockstep_poa_kernel (racon_tpu/ops/poa_pallas_ls.py:64). It computes
// what the plain version ops/poa.py:poa_batch_plain computes, bit for bit:
// graph init, per-layer global sequence-to-graph DP, traceback re-derived
// from H, graph update with float32 fractional column keys, and
// heaviest-bundle consensus with node coverage.
//
// Layout and design:
//   * H, (N + 1) x (max_len + 1) int32 per window (4.7 MB at w=500), does not
//     fit shared memory; it lives in a global scratch the wrapper allocates.
//     So do the in-edge tables (src, w) and the node coverage.
//   * Node keys, bases, the rank order, the layer's sequence and weights and
//     the per-layer serial state live in dynamic shared memory.
//   * DP: one row per subgraph node in rank order; the block's threads cover
//     the row's L + 1 columns in contiguous chunks; the linear-gap pass
//     H[j] = j*g + cummax(V[j] - j*g) is a block scan (per-thread serial,
//     warp shuffles, then the warp totals through shared memory).
//   * The traceback, the graph update and the consensus scoring are serial
//     by nature; warp 0 runs them, its lanes testing the <= 32 in-edge slots
//     of a node at once (ballots give the first slot in insertion order).
//   * The rank order (stable sort by key, ties by node id) is rebuilt after
//     each layer by counting, in parallel over the nodes.
//
// What bounds it on an H100: the serial dependency chains (one DP row after
// another, the traceback, the update), not bytes or integer throughput;
// the design keeps many windows in flight (one block each, modest shared
// memory) so the card hides one window's latency behind others.
//
// Float discipline: keys are float32 and computed in the plain version's
// order of operations; the library is built with --fmad=false and IEEE
// division, so no key drifts by an ulp.
//
// The banded build (template BAND; the wrapper's wband argument) replaces
// the Pallas kernel's band=True build: a per-window half band wband in, a
// band hit out, and the ls build's banded semantics, which the plain
// version runs with kernel="ls". Under wband > 0: column 0's diagonal is
// NEG + mismatch (the Pallas kernel's shifted-in NEG); after its gap pass
// each DP row is masked to NEG outside |j - cexp| <= wband (cexp: the
// node's key + 0.5, truncated, less the layer's begin); the hit is set
// where the best end score's deficit below match x L passes
// 2 |gap| max(wband / 2, 1), and where warp 0's walk (walk_band) leaves a
// node whose visited cells came within one cell of the band edge. Rule 1:
// an end score no better than NEG fails the layer. Rule 2: a layer that
// fails, there or in the walk, adds nothing to the graph. Every column is
// still computed: the mask costs a compare a cell. wband = 0 runs the flat
// code through the same build.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "poa_common.cuh"

#define CHMAX 8  // columns per thread: max_len + 1 <= NT * CHMAX

namespace {

using poa_common::better;
using poa_common::block_best;

struct Cfg {
  int N, ML, MB, E, D, ma, mm, gp;
};

struct Shared {
  float* key;       // [N]
  int* base;        // [N]
  int* order;       // [N] node id by rank
  uint8_t* sub;     // [N]
  uint8_t* has_out; // [N]
  int* score;       // [N]
  int* pred;        // [N]
  int* path;        // [N]
  int* pos_node;    // [ML]
  float* next_key;  // [ML]
  int* run_rem;     // [ML]
  int* seq;         // [ML]
  int* wts;         // [ML]
  int* red_v;       // [NWARP] reduction scratch
  int* red_i;       // [NWARP]
  int* red_w;       // [NWARP]
  int* misc;        // [8]
};

__host__ __device__ inline size_t shared_bytes(int N, int ML) {
  return (size_t)N * (4 * 6 + 2) + (size_t)ML * 4 * 5 + NWARP * 4 * 3 +
         8 * 4 + 64;
}

__device__ inline Shared carve(char* p, int N, int ML) {
  Shared s;
  s.key = (float*)p; p += N * 4;
  s.base = (int*)p; p += N * 4;
  s.order = (int*)p; p += N * 4;
  s.score = (int*)p; p += N * 4;
  s.pred = (int*)p; p += N * 4;
  s.path = (int*)p; p += N * 4;
  s.pos_node = (int*)p; p += ML * 4;
  s.next_key = (float*)p; p += ML * 4;
  s.run_rem = (int*)p; p += ML * 4;
  s.seq = (int*)p; p += ML * 4;
  s.wts = (int*)p; p += ML * 4;
  s.red_v = (int*)p; p += NWARP * 4;
  s.red_i = (int*)p; p += NWARP * 4;
  s.red_w = (int*)p; p += NWARP * 4;
  s.misc = (int*)p; p += 8 * 4;
  s.sub = (uint8_t*)p; p += N;
  s.has_out = (uint8_t*)p; p += N;
  return s;
}

// Rank order over the n used nodes: stable sort by key, ties by node id.
__device__ void rebuild_order(const Shared& s, int n) {
  for (int u = threadIdx.x; u < n; u += NT) {
    const float ku = s.key[u];
    int r = 0;
    for (int v = 0; v < n; ++v) {
      const float kv = s.key[v];
      r += (kv < ku || (kv == ku && v < u)) ? 1 : 0;
    }
    s.order[r] = u;
  }
  __syncthreads();
}

// The banded build's traceback (warp 0, every lane the same result) from
// end node u at column L, re-deriving each move from the masked H as the
// ls Pallas build does: at each node it walks left from the entry column
// to the first cell that a diagonal (column 0's included, where the cell
// is NEG + mismatch) or an up move explains, through the first such slot,
// and takes that move. A node with no such cell at or left of its entry
// is stuck: the walk fails, and that node's cells count for no boundary
// touch. A diagonal off column 0 into a node fails the walk too. Writes
// the matched positions to pos_node and the touch (a visited cell of a
// node the walk left within one cell of the band edge) to *touch; returns
// whether the walk reached the virtual row.
__device__ bool walk_band(const Shared& s, const Cfg& c, const int* H,
                          const int* src, int u, int L, int hw, int begin,
                          int lane, bool* touch) {
  const int HS = c.ML + 1, gp = c.gp;
  const int limit = c.N + c.ML + 2;
  int j = L, steps = 0;
  bool hit = false;
  while (u != -1) {
    const int cexp = (int)(s.key[u] + 0.5f) - begin;
    int sv = -1;
    bool valid = false;
    if (lane < c.E) {
      sv = src[(size_t)u * c.E + lane];
      valid = sv >= 0 && s.sub[sv];
    }
    const unsigned mval = __ballot_sync(0xffffffffu, valid);
    const int* hu = H + (size_t)(u + 1) * HS;
    const int* hs = H + (size_t)(valid ? sv + 1 : 0) * HS;
    bool near = false;
    int move = 2, prd = -1;
    for (;;) {  // the node's insertion run
      if (j < 0 || ++steps > limit) {  // stuck
        *touch = hit;
        return false;
      }
      near |= abs(j - cexp) >= hw - 1;
      const int cur = hu[j];
      const int jm1 = max(j - 1, 0);
      const int sc = s.seq[jm1] == s.base[u] ? c.ma : c.mm;
      const bool d0 = j == 0 && cur == NEG_ + c.mm;
      const bool dg = valid && (d0 || (j > 0 && hs[jm1] + sc == cur));
      const bool upk = valid && hs[j] + gp == cur;
      const unsigned mdg = __ballot_sync(0xffffffffu, dg);
      const unsigned mup = __ballot_sync(0xffffffffu, upk);
      if (mval) {
        if (mdg) {
          move = 0;
          prd = __shfl_sync(0xffffffffu, sv, __ffs(mdg) - 1);
        } else if (mup) {
          move = 1;
          prd = __shfl_sync(0xffffffffu, sv, __ffs(mup) - 1);
        }
      } else if (d0 || (j > 0 && jm1 * gp + sc == cur)) {
        move = 0;
      } else if (j * gp + gp == cur) {
        move = 1;
      }
      if (move != 2) break;
      --j;
    }
    hit |= near;
    if (move == 0) {
      if (j == 0) {  // a diagonal off column 0
        *touch = hit;
        return prd == -1;
      }
      if (lane == 0) s.pos_node[j - 1] = u;
      --j;
    }
    u = prd;
  }
  *touch = hit;
  return true;
}

// First node id v in [0, n) with key == k0 and base == b, or -1 (warp 0).
__device__ int find_node(const Shared& s, int n, float k0, int b, int lane) {
  for (int v0 = 0; v0 < n; v0 += 32) {
    const int v = v0 + lane;
    const bool hit = v < n && s.key[v] == k0 && s.base[v] == b;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (m) return v0 + __ffs(m) - 1;
  }
  return -1;
}

// BAND: the banded build, which takes each window's half band (wband_a; 0
// runs the flat code) and writes its band hit (band_hit_out).
template <bool BAND>
__global__ void __launch_bounds__(NT)
poa_kernel(Cfg c, const uint8_t* __restrict__ bb, const int* __restrict__ bbw,
           const int* __restrict__ bb_len_a, const int* __restrict__ n_layers_a,
           const uint8_t* __restrict__ seqs, const int* __restrict__ ws,
           const int* __restrict__ lens, const int* __restrict__ begins,
           const int* __restrict__ ends, const int* __restrict__ wband_a,
           int* __restrict__ cons_base,
           int* __restrict__ cons_cov, int* __restrict__ cons_len,
           uint8_t* __restrict__ failed_out, int* __restrict__ n_nodes,
           uint8_t* __restrict__ band_hit_out,
           long long* __restrict__ cells, int* __restrict__ scratch,
           size_t scratch_per) {
  extern __shared__ __align__(16) char smem[];
  const int N = c.N, ML = c.ML, E = c.E, gp = c.gp;
  const int HS = ML + 1;
  const int win = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  Shared s = carve(smem, N, ML);
  const poa_common::Red red{s.red_v, s.red_w, s.red_i};

  int* H = scratch + (size_t)win * scratch_per;
  int* src = H + (size_t)(N + 1) * HS;
  int* ew = src + (size_t)N * E;
  int* cov = ew + (size_t)N * E;

  const int bb_len = bb_len_a[win];
  const int hw = BAND ? wband_a[win] : 0;
  const uint8_t* bbp = bb + (size_t)win * c.MB;
  const int* bbwp = bbw + (size_t)win * c.MB;

  // --- graph init: backbone chain
  for (int i = tid; i < N; i += NT) {
    const bool used = i < bb_len;
    s.base[i] = used ? (int)bbp[i] : -1;
    s.key[i] = used ? (float)i : INFINITY;
    cov[i] = used ? 1 : 0;
    for (int e = 0; e < E; ++e) {
      src[(size_t)i * E + e] = -1;
      ew[(size_t)i * E + e] = 0;
    }
    if (used && i > 0) {
      src[(size_t)i * E] = i - 1;
      ew[(size_t)i * E] = bbwp[i - 1] + bbwp[i];
    }
  }
  for (int j = tid; j < HS; j += NT) H[j] = j * gp;  // virtual start row
  if (tid == 0) {
    s.misc[0] = bb_len;  // n
    s.misc[1] = 0;       // failed
    if (BAND) s.misc[6] = 0;  // band hit
  }
  __syncthreads();
  rebuild_order(s, bb_len);

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
    for (int j = tid; j < ML; j += NT) {
      s.seq[j] = j < L ? (int)sq[j] : 0;
      s.wts[j] = j < L ? wq[j] : 0;
      s.pos_node[j] = -1;
    }
    if (tid == 0) {  // r0, n_sub, band cells
      s.misc[2] = 0;
      s.misc[3] = 0;
      if (BAND) s.misc[5] = 0;
    }
    __syncthreads();
    for (int u = tid; u < n; u += NT) {
      const float k = s.key[u];
      const bool in = k >= lo && k <= hi;
      s.sub[u] = in ? 1 : 0;
      s.has_out[u] = 0;
      if (k < lo) atomicAdd(&s.misc[2], 1);
      if (in) atomicAdd(&s.misc[3], 1);
    }
    __syncthreads();
    const int r0 = s.misc[2], n_sub = s.misc[3];
    const bool banded = BAND && hw > 0;
    if (banded) {  // the columns of [0, L] each row's band admits
      int band_cells = 0;
      for (int r = r0 + tid; r < r0 + n_sub; r += NT) {
        const int ce = (int)(s.key[s.order[r]] + 0.5f) - begin;
        band_cells += max(0, min(L, ce + hw) - max(0, ce - hw) + 1);
      }
      atomicAdd(&s.misc[5], band_cells);
      __syncthreads();
      dp_cells += (long long)atomicAdd(&s.misc[5], 0);
    } else {
      dp_cells += (long long)n_sub * (L + 1);
    }

    // --- DP over the subgraph in rank order. sub[u] becomes 2 once u's row
    // is computed; a predecessor ranked later (equal keys along an edge)
    // has no row yet and counts as a row of NEG, as in the plain version.
    const int CH = (L + 1 + NT - 1) / NT;
    const int j0 = tid * CH;
    for (int r = r0; r < r0 + n_sub; ++r) {
      const int u = s.order[r];
      const int ub = s.base[u];
      const int cexp = BAND ? (int)(s.key[u] + 0.5f) - begin : 0;
      int P[CHMAX + 1];
#pragma unroll
      for (int k = 0; k <= CHMAX; ++k) P[k] = NEG_;
      bool any = false;
      for (int e = 0; e < E; ++e) {
        const int sv = src[(size_t)u * E + e];
        if (sv < 0 || !s.sub[sv]) continue;
        any = true;
        if (s.sub[sv] != 2) continue;
        const int* hr = H + (size_t)(sv + 1) * HS;
#pragma unroll
        for (int k = 0; k <= CHMAX; ++k) {
          const int j = j0 - 1 + k;
          if (k <= CH && j >= 0 && j <= L) P[k] = max(P[k], hr[j]);
        }
      }
      if (!any) {
#pragma unroll
        for (int k = 0; k <= CHMAX; ++k) P[k] = (j0 - 1 + k) * gp;
      }
      int x[CHMAX];
      int run = INT_MIN;
#pragma unroll
      for (int k = 0; k < CHMAX; ++k) {
        const int j = j0 + k;
        int v = INT_MIN;
        if (k < CH && j <= L) {
          v = P[k + 1] + gp;
          if (j >= 1) {
            const int sc = s.seq[j - 1] == ub ? c.ma : c.mm;
            v = max(v, P[k] + sc);
          } else if (BAND && hw > 0) {
            v = max(v, NEG_ + c.mm);
          }
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
      for (int w = 0; w < wid; ++w) excl = max(excl, s.red_v[w]);
      int* hrow = H + (size_t)(u + 1) * HS;
#pragma unroll
      for (int k = 0; k < CHMAX; ++k) {
        const int j = j0 + k;
        if (k < CH && j <= L) {
          int row = max(x[k], excl) + j * gp;
          if (BAND && hw > 0 && abs(j - cexp) > hw) row = NEG_;
          hrow[j] = row;
        }
      }
      if (tid == 0) s.sub[u] = 2;
      __syncthreads();
    }
    if (n_sub == 0) {  // the plain version's untouched row of node 0
      for (int j = tid; j <= L; j += NT) H[HS + j] = NEG_;
      __syncthreads();
    }

    // --- end node: first best H[u+1][L] in rank order among sub nodes
    // with no out-edge inside the subgraph
    for (int r = r0 + tid; r < r0 + n_sub; r += NT) {
      const int v = s.order[r];
      for (int e = 0; e < E; ++e) {
        const int sv = src[(size_t)v * E + e];
        if (sv >= 0 && s.sub[sv]) s.has_out[sv] = 1;
      }
    }
    __syncthreads();
    int ba = INT_MIN, bbv = 0, bi = -1;
    for (int r = r0 + tid; r < r0 + n_sub; r += NT) {
      const int u = s.order[r];
      const int sc = s.has_out[u] ? NEG_ : H[(size_t)(u + 1) * HS + L];
      if (bi < 0 || better(sc, 0, r, ba, bbv, bi)) { ba = sc; bi = r; }
    }
    block_best(red, ba, bbv, bi);
    const int start_u = bi >= 0 ? s.order[bi] : 0;
    // the banded walk's outcome: 1 reached the virtual row, 0 failed
    // (rule 1 where no end score passes NEG)
    int walked = 1;
    if (banded) {
      const int best_s = bi >= 0 ? max(ba, NEG_) : NEG_;
      if (tid == 0 && c.ma * L - best_s > 2 * (-c.gp) * max(hw / 2, 1))
        s.misc[6] = 1;
      walked = best_s > NEG_;
    }

    // --- traceback (warp 0)
    if (wid == 0 && banded) {
      bool touch = false;
      if (walked)
        walked = walk_band(s, c, H, src, start_u, L, hw, begin, lane, &touch);
      if (lane == 0) {
        if (touch) s.misc[6] = 1;
        if (!walked) s.misc[1] = 1;
      }
      __syncwarp();
    }
    if (wid == 0 && !banded) {
      int u = start_u, j = L, steps = 0;
      const int limit = N + ML + 2;
      while (!(u == -1 && j == 0) && steps < limit) {
        ++steps;
        if (u == -1) { --j; continue; }
        const int* hu = H + (size_t)(u + 1) * HS;
        const int cur = hu[j];
        const int jm1 = max(j - 1, 0);
        const int sc = s.seq[jm1] == s.base[u] ? c.ma : c.mm;
        int sv = -1;
        bool valid = false, dg = false, upk = false;
        if (lane < E) {
          sv = src[(size_t)u * E + lane];
          valid = sv >= 0 && s.sub[sv];
          if (valid) {
            const int* hs = H + (size_t)(sv + 1) * HS;
            dg = j > 0 && hs[jm1] + sc == cur;
            upk = hs[j] + gp == cur;
          }
        }
        const unsigned mval = __ballot_sync(0xffffffffu, valid);
        const unsigned mdg = __ballot_sync(0xffffffffu, dg);
        const unsigned mup = __ballot_sync(0xffffffffu, upk);
        bool any_diag, any_up;
        int diag_pred = -1, up_pred = -1;
        if (mval) {
          any_diag = mdg != 0;
          any_up = mup != 0;
          if (any_diag) diag_pred = __shfl_sync(0xffffffffu, sv, __ffs(mdg) - 1);
          if (any_up) up_pred = __shfl_sync(0xffffffffu, sv, __ffs(mup) - 1);
        } else {
          any_diag = j > 0 && jm1 * gp + sc == cur;
          any_up = j * gp + gp == cur;
        }
        if (any_diag) {
          if (lane == 0) s.pos_node[j - 1] = u;
          u = diag_pred;
          --j;
        } else if (any_up) {
          u = up_pred;
        } else {
          --j;
        }
        if (j < 0) break;
      }
      if (lane == 0 && !(u == -1 && j == 0)) s.misc[1] = 1;
      __syncwarp();
    }

    // --- graph update (warp 0); under a band, rule 2: only after a walk
    // that reached the virtual row
    if (wid == 0 && walked) {
      if (lane == 0) {
        float nk = INFINITY;
        int runl = ML - L;
        for (int jj = L - 1; jj >= 0; --jj) {
          const int pn = s.pos_node[jj];
          if (pn >= 0) { nk = s.key[pn]; runl = 0; } else { ++runl; }
          s.next_key[jj] = nk;
          s.run_rem[jj] = runl;
        }
      }
      __syncwarp();
      int nn = s.misc[0];
      int failed = s.misc[1];
      int prev = -1, prev_w = 0;
      float prev_key = -1.0f;
      for (int jj = 0; jj < L; ++jj) {
        const int b = s.seq[jj];
        const int wj = s.wts[jj];
        const int pn = s.pos_node[jj];
        const bool is_match = pn >= 0;
        float k0 = INFINITY;
        int found = -1;
        if (is_match) {
          k0 = s.key[pn];
          found = find_node(s, nn, k0, b, lane);
        }
        const float nkj = s.next_key[jj];
        const float hi2 = isfinite(nkj) ? nkj : prev_key + 1.0f;
        const float rr = (float)s.run_rem[jj];
        const float lo2 = prev >= 0 ? prev_key : hi2 - rr - 1.0f;
        const float k_new = lo2 + (hi2 - lo2) / (rr + 1.0f);
        const float key_val = is_match ? k0 : k_new;
        const bool overflow = found < 0 && nn >= N;
        int nid;
        if (found >= 0) {
          nid = found;
        } else {
          nid = min(nn, N - 1);
          if (!overflow) {
            if (lane == 0) { s.base[nid] = b; s.key[nid] = key_val; }
            ++nn;
          }
        }
        __syncwarp();
        if (overflow) {
          failed = 1;
        } else {
          if (lane == 0) cov[nid] += 1;
          if (prev >= 0 &&
              !poa_common::add_edge(src, ew, E, E, nid, prev, prev_w + wj,
                                    lane))
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
    rebuild_order(s, s.misc[0]);
  }

  // --- consensus
  const int n = s.misc[0];
  const int cnt = poa_common::consensus(
      s.order, s.base, n, N, E, E, src, ew, cov, s.score, s.pred, s.path,
      &s.misc[4], red, cons_base + (size_t)win * N,
      cons_cov + (size_t)win * N);
  if (tid == 0) {
    cons_len[win] = cnt;
    failed_out[win] = s.misc[1] ? 1 : 0;
    if (BAND) band_hit_out[win] = s.misc[6] ? 1 : 0;
    n_nodes[win] = n;
    if (cells) cells[win] = dp_cells;
  }
}

using Kernel = decltype(&poa_kernel<false>);

// The kernel instantiation (the banded build where band), with its
// dynamic shared-memory limit raised to sm.
cudaError_t instance_for(bool band, size_t sm, Kernel* fn) {
  *fn = band ? &poa_kernel<true> : &poa_kernel<false>;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sm);
}

}  // namespace

extern "C" {

// Scratch int32 words per window: H, src, w, cov.
long long rt_poa_scratch_words(int N, int ML, int E) {
  return (long long)(N + 1) * (ML + 1) + 2LL * N * E + N;
}

// One block per window. Inputs: bb u8[B,MB], bbw i32[B,MB], bb_len i32[B],
// n_layers i32[B], seqs u8[B,D,ML], ws i32[B,D,ML], lens/begins/ends
// i32[B,D], and wband i32[B] or null: each window's half band (the banded
// build; null runs the flat build). Outputs: cons_base, cons_cov i32[B,N],
// cons_len i32[B], failed u8[B], n_nodes i32[B], band_hit u8[B] (with
// wband); cells i64[B] (may be null): each window's DP cells, sum over its
// layers of subgraph nodes x (layer length + 1), or under a half band the
// columns of [0, L] each row's band admits.
// scratch i32[B, rt_poa_scratch_words].
int rt_poa_launch(int N, int ML, int MB, int E, int D, int ma, int mm,
                  int gp, const void* bb, const void* bbw, const void* bb_len,
                  const void* n_layers, const void* seqs, const void* ws,
                  const void* lens, const void* begins, const void* ends,
                  const void* wband, void* cons_base, void* cons_cov,
                  void* cons_len, void* failed, void* n_nodes, void* band_hit,
                  void* cells, void* scratch, int B, void* stream) {
  if (E > 32 || ML + 1 > NT * CHMAX) return (int)cudaErrorInvalidValue;
  Cfg c{N, ML, MB, E, D, ma, mm, gp};
  const size_t sm = shared_bytes(N, ML);
  Kernel fn = nullptr;
  cudaError_t err = instance_for(wband != nullptr, sm, &fn);
  if (err != cudaSuccess) return (int)err;
  const size_t per = (size_t)rt_poa_scratch_words(N, ML, E);
  fn<<<B, NT, sm, (cudaStream_t)stream>>>(
      c, (const uint8_t*)bb, (const int*)bbw, (const int*)bb_len,
      (const int*)n_layers, (const uint8_t*)seqs, (const int*)ws,
      (const int*)lens, (const int*)begins, (const int*)ends,
      (const int*)wband, (int*)cons_base, (int*)cons_cov, (int*)cons_len,
      (uint8_t*)failed, (int*)n_nodes, (uint8_t*)band_hit, (long long*)cells,
      (int*)scratch, per);
  return (int)cudaGetLastError();
}

// The kernel's registers a thread, local (spill) bytes a thread, dynamic
// shared bytes a block and resident blocks per SM at (N, ML), for the flat
// build or (band) the banded one; out[4].
int rt_poa_occupancy(int N, int ML, int band, int* out) {
  const size_t sm = shared_bytes(N, ML);
  Kernel fn = nullptr;
  cudaError_t err = instance_for(band != 0, sm, &fn);
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
