// Device code shared by the two POA kernels (csrc/poa.cu, csrc/poa_v2.cu):
// the block reduction that picks a winner by (value, secondary, index), the
// in-edge update of the graph update, and the heaviest-bundle consensus.
// Each follows the plain version ops/poa.py bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NEG_ (-(1 << 28))
#define NT 256
#define NWARP (NT / 32)

namespace poa_common {

// Lexicographic "better": larger a, then larger b, then smaller index.
__device__ __forceinline__ bool better(int a1, int b1, int i1, int a2, int b2,
                                       int i2) {
  if (a1 != a2) return a1 > a2;
  if (b1 != b2) return b1 > b2;
  return i1 < i2;
}

// Shared-memory scratch of block_best: NWARP ints each.
struct Red {
  int* v;
  int* w;
  int* i;
};

// Block-wide argmax by (a desc, b desc, idx asc); idx < 0 marks "none".
// All threads get the winner.
__device__ inline void block_best(const Red& red, int& a, int& b, int& idx) {
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
    red.v[wid] = a; red.w[wid] = b; red.i[wid] = idx;
  }
  __syncthreads();
  a = red.v[0]; b = red.w[0]; idx = red.i[0];
  for (int w = 1; w < NWARP; ++w) {
    int a2 = red.v[w], b2 = red.w[w], i2 = red.i[w];
    if (i2 >= 0 && (idx < 0 || better(a2, b2, i2, a, b, idx))) {
      a = a2; b = b2; idx = i2;
    }
  }
  __syncthreads();
}

// Warp 0, all lanes: the edge prev -> nid gains weight `wadd` in the first
// slot that already holds prev, else takes the first empty slot (lanes
// test the <= 32 slots at once; ballots give the first in slot order).
// Returns false when every slot is taken by another source.
__device__ inline bool add_edge(int* src, int* ew, int E, int nid, int prev,
                                int wadd, int lane) {
  int sv = -2;
  if (lane < E) sv = src[(size_t)nid * E + lane];
  const unsigned msame = __ballot_sync(0xffffffffu, sv == prev);
  const unsigned mempty = __ballot_sync(0xffffffffu, sv == -1);
  if (msame) {
    if (lane == __ffs(msame) - 1) ew[(size_t)nid * E + lane] += wadd;
  } else if (mempty) {
    if (lane == __ffs(mempty) - 1) {
      ew[(size_t)nid * E + lane] = wadd;
      src[(size_t)nid * E + lane] = prev;
    }
  } else {
    return false;
  }
  return true;
}

// The consensus of a window's graph: heaviest-bundle scores over the n
// nodes in rank order (`order`, warp 0), the summit (first best score in
// rank order), the backward walk to a source, the forward walk along the
// heaviest out-edges (then the higher score, then the lower node id) to a
// sink; writes bases and coverages of the path to cb, cc (N each, padded
// with -1 and 0) and returns its length. score, pred and path are N-int
// shared arrays; *count is a shared int.
__device__ inline int consensus(const int* order, const int* base, int n,
                                int N, int E, const int* src, const int* ew,
                                const int* cov, int* score, int* pred,
                                int* path, int* count, const Red& red,
                                int* cb, int* cc) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  for (int i = tid; i < N; i += NT) {
    score[i] = 0;
    pred[i] = -1;
  }
  __syncthreads();
  if (wid == 0) {
    for (int r = 0; r < n; ++r) {
      const int u = order[r];
      int sv = -1, wv = NEG_, ps = NEG_;
      if (lane < E) {
        sv = src[(size_t)u * E + lane];
        if (sv >= 0) { wv = ew[(size_t)u * E + lane]; ps = score[sv]; }
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
        score[u] = mval ? wmax + bp : 0;
        pred[u] = mval ? slot_src : -1;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  int ba = INT_MIN, bbv = 0, bi = -1;
  for (int r = tid; r < n; r += NT) {
    const int sc = score[order[r]];
    if (bi < 0 || better(sc, 0, r, ba, bbv, bi)) { ba = sc; bi = r; }
  }
  block_best(red, ba, bbv, bi);
  const int summit = bi >= 0 ? order[bi] : 0;

  // backward walk to a source, then reverse
  if (tid == 0) {
    int u = summit, cnt = 0;
    while (u != -1 && cnt < N) {
      path[cnt++] = u;
      u = pred[u];
    }
    *count = cnt;
  }
  __syncthreads();
  int cnt = *count;
  for (int i = tid; i < cnt / 2; i += NT) {
    const int a = path[i];
    path[i] = path[cnt - 1 - i];
    path[cnt - 1 - i] = a;
  }
  __syncthreads();

  // forward walk from the summit along the heaviest out-edges to a sink
  int u = summit;
  while (cnt < N) {
    int a = INT_MIN, b2 = 0, idx = -1;
    for (int v = tid; v < n; v += NT) {
      int wvv = NEG_;
      for (int e = 0; e < E; ++e)
        if (src[(size_t)v * E + e] == u)
          wvv = max(wvv, ew[(size_t)v * E + e]);
      if (wvv > NEG_ && (idx < 0 || better(wvv, score[v], v, a, b2, idx))) {
        a = wvv; b2 = score[v]; idx = v;
      }
    }
    block_best(red, a, b2, idx);
    if (idx < 0) break;
    if (tid == 0) path[cnt] = idx;
    ++cnt;
    u = idx;
  }
  __syncthreads();

  for (int i = tid; i < N; i += NT) {
    if (i < cnt) {
      const int v = path[i];
      cb[i] = base[v];
      cc[i] = cov[v];
    } else {
      cb[i] = -1;
      cc[i] = 0;
    }
  }
  return cnt;
}

}  // namespace poa_common
