// Device code shared by the two POA kernels (csrc/poa.cu, csrc/poa_v2.cu):
// the block reduction that picks a winner by (value, secondary, index), the
// in-edge update of the graph update, and the heaviest-bundle consensus.
// Each follows the plain version ops/poa.py bit for bit.
//
// The graph's arrays live where each kernel keeps them, so the edge update
// and the consensus are templates on their element types: csrc/poa.cu
// passes int32 arrays (in-edge tables in global memory), csrc/poa_v2.cu
// int16 node ids, uint8 bases and int16 in-edge sources in shared memory.
// A node's in-edge slots are E of a row of ES (ES >= E).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NEG_ (-(1 << 28))
#define NT 256
#define NWARP (NT / 32)

namespace poa_common {

// How an edge weight (global memory) grows and is read, by where the
// in-edge sources live. With the sources in global memory (int32) the
// weight is a plain read-modify-write; with the sources in shared memory
// (int16) nothing waits for the weight, so the add is a fire-and-forget
// atomic, performed in L2, and the consensus reads the weights from L2.
template <typename SrcT>
struct EdgeSpace;
template <>
struct EdgeSpace<int> {
  static __device__ __forceinline__ void add(int* p, int v) { *p += v; }
  static __device__ __forceinline__ int load(const int* p) { return *p; }
};
template <>
struct EdgeSpace<int16_t> {
  static __device__ __forceinline__ void add(int* p, int v) {
    atomicAdd(p, v);
  }
  static __device__ __forceinline__ int load(const int* p) {
    return __ldcg(p);
  }
};

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
template <typename SrcT>
__device__ inline bool add_edge(SrcT* src, int* ew, int E, int ES, int nid,
                                int prev, int wadd, int lane) {
  int sv = -2;
  if (lane < E) sv = src[(size_t)nid * ES + lane];
  const unsigned msame = __ballot_sync(0xffffffffu, sv == prev);
  const unsigned mempty = __ballot_sync(0xffffffffu, sv == -1);
  if (msame) {
    if (lane == __ffs(msame) - 1)
      EdgeSpace<SrcT>::add(&ew[(size_t)nid * ES + lane], wadd);
  } else if (mempty) {
    if (lane == __ffs(mempty) - 1) {
      ew[(size_t)nid * ES + lane] = wadd;
      src[(size_t)nid * ES + lane] = (SrcT)prev;
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
// with -1 and 0) and returns its length. score, pred and path are N-entry
// shared arrays; *count is a shared int.
template <typename IdT, typename BaseT, typename SrcT, typename CovT>
__device__ inline int consensus(const IdT* order, const BaseT* base, int n,
                                int N, int E, int ES, const SrcT* src,
                                const int* ew, const CovT* cov, int* score,
                                IdT* pred, IdT* path, int* count,
                                const Red& red, int* cb, int* cc) {
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
        sv = src[(size_t)u * ES + lane];
        if (sv >= 0) {
          wv = EdgeSpace<SrcT>::load(&ew[(size_t)u * ES + lane]);
          ps = score[sv];
        }
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
        pred[u] = (IdT)(mval ? slot_src : -1);
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
      path[cnt++] = (IdT)u;
      u = pred[u];
    }
    *count = cnt;
  }
  __syncthreads();
  int cnt = *count;
  for (int i = tid; i < cnt / 2; i += NT) {
    const IdT a = path[i];
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
        if (src[(size_t)v * ES + e] == u)
          wvv = max(wvv, EdgeSpace<SrcT>::load(&ew[(size_t)v * ES + e]));
      if (wvv > NEG_ && (idx < 0 || better(wvv, score[v], v, a, b2, idx))) {
        a = wvv; b2 = score[v]; idx = v;
      }
    }
    block_best(red, a, b2, idx);
    if (idx < 0) break;
    if (tid == 0) path[cnt] = (IdT)idx;
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
