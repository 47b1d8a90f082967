// Code shared by the two POA kernels (csrc/poa.cu, csrc/poa_v2.cu): the
// block reduction that picks a winner by (value, secondary, index), the
// in-edge update of the graph update, the heaviest-bundle consensus, the
// rank-order helpers of the frozen-order graph update, the global scratch
// layout (with the global build's graph) and the launch's plan. Each
// follows the plain version ops/poa.py bit for bit.
//
// The graph's arrays live where each kernel keeps them (its Shared
// struct), so the helpers are templates on their types: both kernels pass
// uint8 bases and node ids (in-edge sources included) of type Sh::Id, in
// shared memory or, where the graph is too large, in the global scratch.
// The ids are int16 in every build but the global build at max_nodes
// above INT16_NODES, which takes int32 ids (wide_ids). A node's in-edge
// slots are E of a row of ES (ES >= E).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NEG_ (-(1 << 28))
#define NT 256
#define NWARP (NT / 32)
// Columns a thread owns at most: max_len + 1 <= NT * CHMAX in a kernel's
// usual build, NT * CHWIDE in its wide build (make_config's window classes
// above 1280), which caps registers at 255 a thread and runs one block an
// SM. The global build (CX = CHGLOBAL), which a launch takes where no
// shared-memory layout fits, keeps the graph in the global scratch and
// runs each DP row in tiles of TW = NT * CHMAX columns, so it takes any
// max_len.
#define CHMAX 8
#define CHWIDE 16
#define CHGLOBAL 0
#define TW (NT * CHMAX)
// Shared bytes of the global build: the phase cycles, the reductions, the
// scan's two buffers of warp totals and misc, rounded up.
#define GLOBAL_SHARED 512
// The most node ids an int16 id takes. Above it (make_config's window
// classes above 10,880) the global build, the only build such a geometry
// plans, takes int32 ids: in that build the graph lives in the window's
// global scratch, so the wider ids cost scratch bytes, not occupancy.
#define INT16_NODES 32767

namespace poa_common {

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Whether a build takes int32 node ids: the global build (glob) above
// INT16_NODES node slots; every other build int16.
__host__ __device__ inline bool wide_ids(int N, bool glob) {
  return glob && N > INT16_NODES;
}

// How an edge weight (global memory) grows and is read: nothing waits for
// the weight, so the add is a fire-and-forget atomic, performed in L2, and
// the consensus reads the weights from L2.
struct EdgeSpace {
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
      EdgeSpace::add(&ew[(size_t)nid * ES + lane], wadd);
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
          wv = EdgeSpace::load(&ew[(size_t)u * ES + lane]);
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
          wvv = max(wvv, EdgeSpace::load(&ew[(size_t)v * ES + e]));
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

// The rank-order helpers read a kernel's Shared struct (template Sh): its
// key, order, base and path arrays.

// In-edge slots a node's row holds: max_edges rounded up to 4.
__host__ __device__ inline int edge_stride(int E) { return (E + 3) & ~3; }

// The global build's graph and per-position arrays, as byte offsets from
// the start of their part of the scratch (G_* name each array; both
// kernels' arrays, each 16-byte aligned); off[G_END] is the total. left
// holds, for each tile of a DP row and thread, the running max of the row
// just finished at the cell left of the thread's first column. The node-id
// arrays (order, rank_of, path, found) and v2's band starts (bstart, a
// column that passes 32,767 where max_len does) take 2 bytes an entry, 4
// with wide_ids.
enum {
  G_DESC, G_KEY, G_ESC, G_COV, G_NKEY, G_RUNREM, G_WTS, G_LEFT, G_ORDER,
  G_RANK, G_PATH, G_BSTART, G_FOUND, G_BASE, G_SEQ, G_HASOUT, G_STEP, G_FAR,
  G_END
};

// Tiles of TW columns that cover a DP row of ML + 1 columns.
__host__ __device__ inline int n_tiles(int ML) { return (ML + TW) / TW; }

__host__ __device__ inline void graph_layout(int N, int ML, size_t* off) {
  const size_t n = N, ml = ML, idb = wide_ids(N, true) ? 4 : 2;
  const size_t sz[G_END] = {
      n * 8, n * 4, n * 4, n * 4, ml * 4, ml * 4, ml * 4,
      (size_t)n_tiles(ML) * NT * 4, n * idb, n * idb, n * idb, n * idb,
      ml * idb, n, ml, n, n, n};
  size_t p = 0;
  for (int i = 0; i < G_END; ++i) {
    off[i] = p;
    p = align16(p + sz[i]);
  }
  off[G_END] = p;
}

// A window's global scratch, as int32 word offsets: H [N + 1][ML + 1],
// the edge weights [N][ES], the in-edge sources ([N][ES] ids, int16 or,
// with wide_ids, int32; used with GSRC), the move records [N + 1][ML + 1],
// and in the global build (glob) the graph (graph_layout) from off[3];
// off[4] is the total, a multiple of 4 words so that every window's
// sources and graph are 16-byte aligned.
__host__ __device__ inline void scratch_layout(int N, int ML, int ES,
                                               bool glob, size_t* off) {
  const size_t cells = (size_t)(N + 1) * (ML + 1);
  const size_t edges = (size_t)N * ES;
  off[0] = cells;
  off[1] = (cells + edges + 3) & ~(size_t)3;
  off[2] = off[1] + (wide_ids(N, glob) ? edges : edges / 2);
  off[3] = (off[2] + (cells + 3) / 4 + 3) & ~(size_t)3;
  size_t g[G_END + 1];
  graph_layout(N, ML, g);
  off[4] = off[3] + (glob ? g[G_END] / 4 : 0);
}

// The global build's carve of a kernel's Shared struct (template Sh, both
// kernels' fields, ids of type Sh::Id): the graph and the per-position
// arrays from g in the window's global scratch (graph_layout), the in-edge
// sources at gsrc; no ring. Each kernel carves its shared-memory fields
// and its own extras.
template <class Sh>
__device__ inline void carve_graph(Sh& s, char* g, int N, int ML,
                                   typename Sh::Id* gsrc) {
  using Id = typename Sh::Id;
  size_t off[G_END + 1];
  graph_layout(N, ML, off);
  s.desc = (unsigned long long*)(g + off[G_DESC]);
  s.ring = nullptr;
  s.key = (float*)(g + off[G_KEY]);
  s.esc = (int*)(g + off[G_ESC]);
  s.cov = (int*)(g + off[G_COV]);
  s.nkey = (float*)(g + off[G_NKEY]);
  s.runrem = (int*)(g + off[G_RUNREM]);
  s.wts = (int*)(g + off[G_WTS]);
  s.left = (int*)(g + off[G_LEFT]);
  s.src = gsrc;
  s.order = (Id*)(g + off[G_ORDER]);
  s.rank_of = (Id*)(g + off[G_RANK]);
  s.path = (Id*)(g + off[G_PATH]);
  s.found = (Id*)(g + off[G_FOUND]);
  s.base = (uint8_t*)(g + off[G_BASE]);
  s.seq = (uint8_t*)(g + off[G_SEQ]);
  s.has_out = (uint8_t*)(g + off[G_HASOUT]);
  s.far = (uint8_t*)(g + off[G_FAR]);
}

// Ranks in [0, n) whose key is < k (strict) or <= k, by binary search over
// the sorted order.
template <class Sh>
__device__ __forceinline__ int count_keys(const Sh& s, int n, float k,
                                          bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float km = s.key[s.order[mid]];
    if (km < k || (or_equal && km == k)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First node id among the n nodes of the frozen order with key == k0 and
// base == b, or -1 (one thread). Equal keys are adjacent in rank order, by
// id.
template <class Sh>
__device__ int find_old(const Sh& s, int n, float k0, int b) {
  for (int r = count_keys(s, n, k0, false); r < n; ++r) {
    const int v = s.order[r];
    if (s.key[v] != k0) return -1;
    if (s.base[v] == b) return v;
  }
  return -1;
}

// First id in [lo, hi) (this layer's new nodes) with key == k0 and
// base == b, or -1 (warp 0, all lanes get the answer).
template <class Sh>
__device__ int find_new(const Sh& s, int lo, int hi, float k0, int b,
                        int lane) {
  for (int v0 = lo; v0 < hi; v0 += 32) {
    const int v = v0 + lane;
    const unsigned m = __ballot_sync(
        0xffffffffu, v < hi && s.key[v] == k0 && s.base[v] == b);
    if (m) return v0 + __ffs(m) - 1;
  }
  return -1;
}

// Merges the layer's new ids [n, nn) into the frozen order[0, n) by
// (key, id); an old node goes before a new one of equal key, since every
// new id is larger than every old one. Each node's rank is counted: an old
// node's rank plus the new keys below its key; a new node's place among
// the new ones (its index, where the walk left their keys non-decreasing,
// as it does, else counted) plus the old keys <= its key. Block-wide; path
// is the scratch.
template <class Sh>
__device__ void merge_new(const Sh& s, int n, int nn) {
  const int tid = threadIdx.x;
  const int M = nn - n;
  int unsorted = 0;
  for (int m = tid; m + 1 < M; m += NT)
    unsorted |= s.key[n + m] > s.key[n + m + 1];
  const bool sorted = !__syncthreads_or(unsorted);
  for (int i = tid; i < n; i += NT) {    // old: i + new keys < its key
    const int o = s.order[i];
    const float k = s.key[o];
    int below = 0;
    if (sorted) {
      int lo = 0, hi = M;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s.key[n + mid] < k) lo = mid + 1; else hi = mid;
      }
      below = lo;
    } else {
      for (int m = 0; m < M; ++m) below += s.key[n + m] < k;
    }
    s.path[i + below] = (typename Sh::Id)o;
  }
  for (int m = tid; m < M; m += NT) {    // new: its place among the new
    const float k = s.key[n + m];        // plus old keys <= its key
    int before = m;
    if (!sorted) {
      before = 0;
      for (int q = 0; q < M; ++q) {
        const float kq = s.key[n + q];
        before += kq < k || (kq == k && q < m);
      }
    }
    s.path[before + count_keys(s, n, k, true)] = (typename Sh::Id)(n + m);
  }
  __syncthreads();
  for (int i = tid; i < nn; i += NT) s.order[i] = s.path[i];
  __syncthreads();
}

// Whether a window of max_len ML runs the wide build (16 columns a thread).
__host__ __device__ inline bool wide_build(int ML) {
  return ML + 1 > NT * CHMAX;
}

// The launch's plan at (N, ML, ES) for a kernel whose shared-memory layout
// takes bytes(N, ML, ES, ring, gsrc): the largest ring of max_ring,
// max_ring / 2, ... 2 rows that fits the card's opt-in shared memory a
// block, with the in-edge sources in shared memory where any ring fits so,
// else in the global scratch. The wide build always keeps them in the
// global scratch: at its geometries (N >= 4224) they take 100 KB or more,
// and only that instantiation of it is built. Where no layout fits, or
// max_len + 1 exceeds the wide build's NT * CHWIDE columns, the global
// build (*glob; no ring, GLOBAL_SHARED bytes), as also above INT16_NODES
// node slots, where only it takes the ids (int32): chosen by geometry,
// before any launch.
inline cudaError_t plan(int N, int ML, int ES, int max_ring,
                        size_t (*bytes)(int, int, int, int, bool), int* ring,
                        bool* gsrc, bool* glob, size_t* sm) {
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *glob = false;
  if (ML + 1 <= NT * CHWIDE && N <= INT16_NODES)
    for (int g = wide_build(ML) ? 1 : 0; g < 2; ++g)
      for (int rg = max_ring; rg >= 2; rg >>= 1) {
        const size_t b = bytes(N, ML, ES, rg, g != 0);
        if (b <= (size_t)cap) {
          *ring = rg;
          *gsrc = g != 0;
          *sm = b;
          return cudaSuccess;
        }
      }
  *ring = 0;
  *gsrc = true;
  *glob = true;
  *sm = GLOBAL_SHARED;
  return cudaSuccess;
}

}  // namespace poa_common
