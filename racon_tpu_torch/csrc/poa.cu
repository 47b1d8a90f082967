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

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define NEG_ (-(1 << 28))
#define NT 256
#define NWARP (NT / 32)
#define CHMAX 8  // columns per thread: max_len + 1 <= NT * CHMAX

namespace {

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

// Lexicographic "better": larger a, then larger b, then smaller index.
__device__ __forceinline__ bool better(int a1, int b1, int i1, int a2, int b2,
                                       int i2) {
  if (a1 != a2) return a1 > a2;
  if (b1 != b2) return b1 > b2;
  return i1 < i2;
}

// Block-wide argmax by (a desc, b desc, idx asc); idx < 0 marks "none".
// All threads get the winner. Uses s.red_*.
__device__ void block_best(const Shared& s, int& a, int& b, int& idx) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) {
    int a2 = __shfl_down_sync(0xffffffffu, a, d);
    int b2 = __shfl_down_sync(0xffffffffu, b, d);
    int i2 = __shfl_down_sync(0xffffffffu, idx, d);
    if (i2 >= 0 && (idx < 0 || better(a2, b2, i2, a, b, idx))) {
      a = a2; b = b2; idx = i2;
    }
  }
  __syncthreads();
  if (lane == 0) {
    s.red_v[wid] = a; s.red_w[wid] = b; s.red_i[wid] = idx;
  }
  __syncthreads();
  a = s.red_v[0]; b = s.red_w[0]; idx = s.red_i[0];
  for (int w = 1; w < NWARP; ++w) {
    int a2 = s.red_v[w], b2 = s.red_w[w], i2 = s.red_i[w];
    if (i2 >= 0 && (idx < 0 || better(a2, b2, i2, a, b, idx))) {
      a = a2; b = b2; idx = i2;
    }
  }
  __syncthreads();
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

__global__ void __launch_bounds__(NT)
poa_kernel(Cfg c, const uint8_t* __restrict__ bb, const int* __restrict__ bbw,
           const int* __restrict__ bb_len_a, const int* __restrict__ n_layers_a,
           const uint8_t* __restrict__ seqs, const int* __restrict__ ws,
           const int* __restrict__ lens, const int* __restrict__ begins,
           const int* __restrict__ ends, int* __restrict__ cons_base,
           int* __restrict__ cons_cov, int* __restrict__ cons_len,
           uint8_t* __restrict__ failed_out, int* __restrict__ n_nodes,
           long long* __restrict__ cells, int* __restrict__ scratch,
           size_t scratch_per) {
  extern __shared__ __align__(16) char smem[];
  const int N = c.N, ML = c.ML, E = c.E, gp = c.gp;
  const int HS = ML + 1;
  const int win = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  Shared s = carve(smem, N, ML);

  int* H = scratch + (size_t)win * scratch_per;
  int* src = H + (size_t)(N + 1) * HS;
  int* ew = src + (size_t)N * E;
  int* cov = ew + (size_t)N * E;

  const int bb_len = bb_len_a[win];
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
    if (tid == 0) { s.misc[2] = 0; s.misc[3] = 0; }  // r0, n_sub
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
    dp_cells += (long long)n_sub * (L + 1);

    // --- DP over the subgraph in rank order
    const int CH = (L + 1 + NT - 1) / NT;
    const int j0 = tid * CH;
    for (int r = r0; r < r0 + n_sub; ++r) {
      const int u = s.order[r];
      const int ub = s.base[u];
      int P[CHMAX + 1];
#pragma unroll
      for (int k = 0; k <= CHMAX; ++k) P[k] = NEG_;
      bool any = false;
      for (int e = 0; e < E; ++e) {
        const int sv = src[(size_t)u * E + e];
        if (sv < 0 || !s.sub[sv]) continue;
        any = true;
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
        if (k < CH && j <= L) hrow[j] = max(x[k], excl) + j * gp;
      }
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
    block_best(s, ba, bbv, bi);
    const int start_u = bi >= 0 ? s.order[bi] : 0;

    // --- traceback (warp 0)
    if (wid == 0) {
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

      // --- graph update (warp 0)
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
          if (prev >= 0) {
            int sv = -2;
            if (lane < E) sv = src[(size_t)nid * E + lane];
            const unsigned msame = __ballot_sync(0xffffffffu, sv == prev);
            const unsigned mempty = __ballot_sync(0xffffffffu, sv == -1);
            if (msame) {
              if (lane == __ffs(msame) - 1) ew[(size_t)nid * E + lane] += prev_w + wj;
            } else if (mempty) {
              if (lane == __ffs(mempty) - 1) {
                ew[(size_t)nid * E + lane] = prev_w + wj;
                src[(size_t)nid * E + lane] = prev;
              }
            } else {
              failed = 1;
            }
          }
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

  // --- consensus: heaviest bundle in rank order (warp 0)
  const int n = s.misc[0];
  for (int i = tid; i < N; i += NT) {
    s.score[i] = 0;
    s.pred[i] = -1;
  }
  __syncthreads();
  if (wid == 0) {
    for (int r = 0; r < n; ++r) {
      const int u = s.order[r];
      int sv = -1, wv = NEG_, ps = NEG_;
      if (lane < E) {
        sv = src[(size_t)u * E + lane];
        if (sv >= 0) { wv = ew[(size_t)u * E + lane]; ps = s.score[sv]; }
      }
      const bool valid = sv >= 0;
      const unsigned mval = __ballot_sync(0xffffffffu, valid);
      int wmax = wv;
      for (int d = 16; d > 0; d >>= 1)
        wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, d));
      // among slots with w == wmax: largest ps, then lowest slot
      int bp = (valid && wv == wmax) ? ps : INT_MIN;
      int bl = (valid && wv == wmax) ? lane : 64;
      for (int d = 16; d > 0; d >>= 1) {
        const int p2 = __shfl_xor_sync(0xffffffffu, bp, d);
        const int l2 = __shfl_xor_sync(0xffffffffu, bl, d);
        if (p2 > bp || (p2 == bp && l2 < bl)) { bp = p2; bl = l2; }
      }
      const int slot_src = __shfl_sync(0xffffffffu, sv, bl & 31);
      if (lane == 0) {
        s.score[u] = mval ? wmax + bp : 0;
        s.pred[u] = mval ? slot_src : -1;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  int ba = INT_MIN, bbv = 0, bi = -1;
  for (int r = tid; r < n; r += NT) {
    const int sc = s.score[s.order[r]];
    if (bi < 0 || better(sc, 0, r, ba, bbv, bi)) { ba = sc; bi = r; }
  }
  block_best(s, ba, bbv, bi);
  const int summit = bi >= 0 ? s.order[bi] : 0;

  // backward walk to a source, then reverse
  if (tid == 0) {
    int u = summit, cnt = 0;
    while (u != -1 && cnt < N) {
      s.path[cnt++] = u;
      u = s.pred[u];
    }
    s.misc[4] = cnt;
  }
  __syncthreads();
  {
    const int cnt = s.misc[4];
    // reverse path[0, cnt) in place
    for (int i = tid; i < cnt / 2; i += NT) {
      const int a = s.path[i];
      s.path[i] = s.path[cnt - 1 - i];
      s.path[cnt - 1 - i] = a;
    }
  }
  __syncthreads();

  // forward walk from the summit along the heaviest out-edges to a sink
  int cnt = s.misc[4];
  int u = summit;
  while (cnt < N) {
    int a = INT_MIN, b2 = 0, idx = -1;
    for (int v = tid; v < n; v += NT) {
      int wvv = NEG_;
      for (int e = 0; e < E; ++e)
        if (src[(size_t)v * E + e] == u) wvv = max(wvv, ew[(size_t)v * E + e]);
      if (wvv > NEG_ && (idx < 0 || better(wvv, s.score[v], v, a, b2, idx))) {
        a = wvv; b2 = s.score[v]; idx = v;
      }
    }
    block_best(s, a, b2, idx);
    if (idx < 0) break;
    if (tid == 0) s.path[cnt] = idx;
    ++cnt;
    u = idx;
  }
  __syncthreads();

  int* cb = cons_base + (size_t)win * N;
  int* cc = cons_cov + (size_t)win * N;
  for (int i = tid; i < N; i += NT) {
    if (i < cnt) {
      const int v = s.path[i];
      cb[i] = s.base[v];
      cc[i] = cov[v];
    } else {
      cb[i] = -1;
      cc[i] = 0;
    }
  }
  if (tid == 0) {
    cons_len[win] = cnt;
    failed_out[win] = s.misc[1] ? 1 : 0;
    n_nodes[win] = n;
    if (cells) cells[win] = dp_cells;
  }
}

}  // namespace

extern "C" {

// Scratch int32 words per window: H, src, w, cov.
long long rt_poa_scratch_words(int N, int ML, int E) {
  return (long long)(N + 1) * (ML + 1) + 2LL * N * E + N;
}

// One block per window. Inputs: bb u8[B,MB], bbw i32[B,MB], bb_len i32[B],
// n_layers i32[B], seqs u8[B,D,ML], ws i32[B,D,ML], lens/begins/ends
// i32[B,D]. Outputs: cons_base, cons_cov i32[B,N], cons_len i32[B],
// failed u8[B], n_nodes i32[B]; cells i64[B] (may be null): each window's DP
// cells, sum over its layers of subgraph nodes x (layer length + 1).
// scratch i32[B, rt_poa_scratch_words].
int rt_poa_launch(int N, int ML, int MB, int E, int D, int ma, int mm,
                  int gp, const void* bb, const void* bbw, const void* bb_len,
                  const void* n_layers, const void* seqs, const void* ws,
                  const void* lens, const void* begins, const void* ends,
                  void* cons_base, void* cons_cov, void* cons_len,
                  void* failed, void* n_nodes, void* cells, void* scratch,
                  int B,
                  void* stream) {
  if (E > 32 || ML + 1 > NT * CHMAX) return (int)cudaErrorInvalidValue;
  Cfg c{N, ML, MB, E, D, ma, mm, gp};
  const size_t sm = shared_bytes(N, ML);
  cudaError_t err = cudaFuncSetAttribute(
      poa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (err != cudaSuccess) return (int)err;
  const size_t per = (size_t)rt_poa_scratch_words(N, ML, E);
  poa_kernel<<<B, NT, sm, (cudaStream_t)stream>>>(
      c, (const uint8_t*)bb, (const int*)bbw, (const int*)bb_len,
      (const int*)n_layers, (const uint8_t*)seqs, (const int*)ws,
      (const int*)lens, (const int*)begins, (const int*)ends,
      (int*)cons_base, (int*)cons_cov, (int*)cons_len, (uint8_t*)failed,
      (int*)n_nodes, (long long*)cells, (int*)scratch, per);
  return (int)cudaGetLastError();
}

}  // extern "C"
