// Hirschberg banded global aligner: edge-row and base-case kernels.
//
// Replace the JAX package's Pallas kernels _build_edge_kernel
// (racon_tpu/ops/align_pallas.py:112) and _build_base_kernel (:299).
// Semantics are those of the plain versions in ops/align_cuda.py
// (edge_rows_plain, base_plain), bit for bit.
//
// Layout: one warp per task. Lane o of the K-wide band row lives in
// thread o / PER, register slot o % PER (PER = K / 32 contiguous lanes per
// thread), so a DP row needs no shared memory and no block barrier: the
// one-lane neighbour crosses threads by one shuffle, and the in-row gap
// pass is a per-thread serial prefix (suffix) min followed by a warp
// shuffle scan of the thread totals.
//
// What bounds it on an H100: integer operations and the serial row
// dependency (R rows, each ~10 int ops per lane). The target codes are
// read as bytes from global memory through L1; the base case's moves are
// written to a global scratch of one byte per cell and read back by lane 0
// during the traceback.
//
// C interface (ctypes): every launch function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define INF_ (1 << 28)
#define BASE_ROWS 256
#define WARPS 4

namespace {

__device__ __forceinline__ int warp_prefix_min(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = min(v, o);
  }
  return v;
}

__device__ __forceinline__ int warp_suffix_min(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_down_sync(0xffffffffu, v, d);
    if (lane + d < 32) v = min(v, o);
  }
  return v;
}

// x[p] <- min(x[0..p]) across the whole K-lane row (inclusive).
template <int PER>
__device__ __forceinline__ void row_prefix_min(int (&x)[PER], int lane) {
#pragma unroll
  for (int p = 1; p < PER; ++p) x[p] = min(x[p], x[p - 1]);
  int tot = warp_prefix_min(x[PER - 1], lane);
  int excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0x7fffffff;
#pragma unroll
  for (int p = 0; p < PER; ++p) x[p] = min(x[p], excl);
}

// x[p] <- min(x[p..K-1]) across the whole row (inclusive).
template <int PER>
__device__ __forceinline__ void row_suffix_min(int (&x)[PER], int lane) {
#pragma unroll
  for (int p = PER - 2; p >= 0; --p) x[p] = min(x[p], x[p + 1]);
  int tot = warp_suffix_min(x[0], lane);
  int excl = __shfl_down_sync(0xffffffffu, tot, 1);
  if (lane == 31) excl = 0x7fffffff;
#pragma unroll
  for (int p = 0; p < PER; ++p) x[p] = min(x[p], excl);
}

__device__ __forceinline__ int tcode(const uint8_t* t, int idx, int tcap) {
  return (idx >= 0 && idx < tcap) ? (int)__ldg(t + idx) : 255;
}

template <int K, bool BACKWARD>
__global__ void edge_kernel(const int* __restrict__ scal,
                            const uint8_t* __restrict__ q,
                            const uint8_t* __restrict__ t,
                            int* __restrict__ out, int B, int rcap,
                            int tcap) {
  constexpr int PER = K / 32;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= B) return;  // whole warp leaves together
  const int R = scal[task * 4 + 0];
  const int S = scal[task * 4 + 1];
  const int dmin = scal[task * 4 + 2];
  const uint8_t* qt = q + (size_t)task * rcap;
  const uint8_t* tt = t + (size_t)task * tcap;
  const int o0 = lane * PER;
  int row[PER];

  if (!BACKWARD) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      int j0 = dmin + o0 + p;
      row[p] = (j0 >= 0 && j0 <= S) ? j0 : INF_;
    }
    for (int i = 1; i <= R; ++i) {
      const int qc = __ldg(qt + i - 1);
      // old row[o + 1] for this thread's last lane
      int nb = __shfl_down_sync(0xffffffffu, row[0], 1);
      if (lane == 31) nb = INF_;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int o = o0 + p;
        const int jv = i + dmin + o;
        const int up = (p + 1 < PER ? row[p + 1] : nb) + 1;
        const int sub = row[p] + (tcode(tt, jv - 1, tcap) != qc ? 1 : 0);
        int V = min(sub, up);
        if (jv == 0) V = i;
        if (jv < 0 || jv > S) V = INF_;
        row[p] = V - o;
      }
      row_prefix_min<PER>(row, lane);
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int o = o0 + p;
        const int jv = i + dmin + o;
        const int v = min(row[p] + o, INF_);
        row[p] = (jv < 0 || jv > S) ? INF_ : v;
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      int jr = R + dmin + o0 + p;
      row[p] = (jr >= 0 && jr <= S) ? S - jr : INF_;
    }
    for (int k = 0; k < R; ++k) {
      const int i = R - 1 - k;
      const int qc = __ldg(qt + i);
      // old row[o - 1] for this thread's first lane
      int nb = __shfl_up_sync(0xffffffffu, row[PER - 1], 1);
      if (lane == 0) nb = INF_;
#pragma unroll
      for (int p = PER - 1; p >= 0; --p) {
        const int o = o0 + p;
        const int jv = i + dmin + o;
        const int down = (p > 0 ? row[p - 1] : nb) + 1;
        const int sub = row[p] + (tcode(tt, jv, tcap) != qc ? 1 : 0);
        int V = min(sub, down);
        if (jv == S) V = R - i;
        if (jv < 0 || jv > S) V = INF_;
        row[p] = V - (K - 1 - o);
      }
      row_suffix_min<PER>(row, lane);
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int o = o0 + p;
        const int jv = i + dmin + o;
        const int v = min(row[p] + (K - 1 - o), INF_);
        row[p] = (jv < 0 || jv > S) ? INF_ : v;
      }
    }
  }
  int* dst = out + (size_t)task * K + o0;
#pragma unroll
  for (int p = 0; p < PER; ++p) dst[p] = row[p];
}

template <int K>
__global__ void base_kernel(const int* __restrict__ scal,
                            const uint8_t* __restrict__ q,
                            const uint8_t* __restrict__ t,
                            int* __restrict__ ops, int* __restrict__ cnt_out,
                            int* __restrict__ ok_out,
                            int* __restrict__ dist_out,
                            uint8_t* __restrict__ moves, int B, int tcap,
                            int n_ops) {
  constexpr int PER = K / 32;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= B) return;
  const int R = scal[task * 4 + 0];
  const int S = scal[task * 4 + 1];
  const int dmin = scal[task * 4 + 2];
  const uint8_t* qt = q + (size_t)task * BASE_ROWS;
  const uint8_t* tt = t + (size_t)task * tcap;
  uint8_t* mvs = moves + (size_t)task * BASE_ROWS * K;
  const int o0 = lane * PER;
  int row[PER];
  int c[PER];

#pragma unroll
  for (int p = 0; p < PER; ++p) {
    int j0 = dmin + o0 + p;
    row[p] = (j0 >= 0 && j0 <= S) ? j0 : INF_;
  }
  const int rows = min(R, BASE_ROWS);
  for (int i = 1; i <= rows; ++i) {
    const int qc = __ldg(qt + i - 1);
    int nb = __shfl_down_sync(0xffffffffu, row[0], 1);
    if (lane == 31) nb = INF_;
    uint32_t mv1[(PER + 31) / 32];
#pragma unroll
    for (int w = 0; w < (PER + 31) / 32; ++w) mv1[w] = 0;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int o = o0 + p;
      const int jv = i + dmin + o;
      const int up = (p + 1 < PER ? row[p + 1] : nb) + 1;
      const int sub = row[p] + (tcode(tt, jv - 1, tcap) != qc ? 1 : 0);
      int V = min(sub, up);
      bool m1 = V != sub;
      if (jv == 0) {
        V = i;
        m1 = true;
      }
      if (jv < 0 || jv > S) V = INF_;
      if (m1) mv1[p / 32] |= 1u << (p % 32);
      row[p] = V;
      c[p] = V - o;
    }
    row_prefix_min<PER>(c, lane);
    uint8_t* mrow = mvs + (size_t)(i - 1) * K + o0;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int o = o0 + p;
      const int jv = i + dmin + o;
      // the Pallas scan's INF fill reaches every lane but the last
      const int cc = (o < K - 1) ? min(c[p], INF_) : c[p];
      const int nrow = cc + o;
      int mv = ((mv1[p / 32] >> (p % 32)) & 1u) ? 1 : 0;
      if (nrow < row[p]) mv = 2;
      mrow[p] = (uint8_t)mv;
      row[p] = (jv < 0 || jv > S) ? INF_ : nrow;
    }
  }

  // terminal distance DP[R][S]
  const int o_fin = S - R - dmin;
  if (o_fin >= o0 && o_fin < o0 + PER) {
#pragma unroll
    for (int p = 0; p < PER; ++p)
      if (o0 + p == o_fin) dist_out[task] = row[p];
  } else if (lane == 0 && (o_fin < 0 || o_fin >= K)) {
    dist_out[task] = INF_;
  }

  int* optr = ops + (size_t)task * n_ops;
  for (int x = lane; x < n_ops; x += 32) optr[x] = 0;
  __syncwarp();
  if (lane == 0) {
    int i = R, j = S, cnt = 0;
    bool ok = true;
    while ((i > 0 || j > 0) && cnt < n_ops && ok) {
      const int o = j - i - dmin;
      int mv;
      if (i > 0)
        mv = (o >= 0 && o < K && i <= BASE_ROWS) ? (int)mvs[(size_t)(i - 1) * K + o]
                                                  : 3;
      else
        mv = 2;
      ok = mv != 3;
      optr[cnt] = mv;
      if (mv != 2) --i;
      if (mv != 1) --j;
      ++cnt;
    }
    cnt_out[task] = cnt;
    ok_out[task] = (ok && i == 0 && j == 0) ? 1 : 0;
  }
}

template <int K>
cudaError_t launch_edge(const int* scal, const uint8_t* q, const uint8_t* t,
                        int* out, int B, int rcap, int tcap, int backward,
                        cudaStream_t s) {
  dim3 grid((B + WARPS - 1) / WARPS), block(32 * WARPS);
  if (backward)
    edge_kernel<K, true><<<grid, block, 0, s>>>(scal, q, t, out, B, rcap,
                                                 tcap);
  else
    edge_kernel<K, false><<<grid, block, 0, s>>>(scal, q, t, out, B, rcap,
                                                  tcap);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_base(const int* scal, const uint8_t* q, const uint8_t* t,
                        int* ops, int* cnt, int* ok, int* dist,
                        uint8_t* moves, int B, int tcap, int n_ops,
                        cudaStream_t s) {
  dim3 grid((B + WARPS - 1) / WARPS), block(32 * WARPS);
  base_kernel<K><<<grid, block, 0, s>>>(scal, q, t, ops, cnt, ok, dist,
                                        moves, B, tcap, n_ops);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Last band row of the forward (backward) DP per task.
// scal i32[B,4] = (R, S, dmin, 0); q u8[B,rcap]; t u8[B,tcap]; out i32[B,K].
int rt_edge_launch(const void* scal, const void* q, const void* t, void* out,
                   int B, int rcap, int K, int tcap, int backward,
                   void* stream) {
  auto s = (cudaStream_t)stream;
  auto sc = (const int*)scal;
  auto qq = (const uint8_t*)q;
  auto tt = (const uint8_t*)t;
  auto o = (int*)out;
  switch (K) {
    case 256: return launch_edge<256>(sc, qq, tt, o, B, rcap, tcap, backward, s);
    case 512: return launch_edge<512>(sc, qq, tt, o, B, rcap, tcap, backward, s);
    case 1024: return launch_edge<1024>(sc, qq, tt, o, B, rcap, tcap, backward, s);
    case 2048: return launch_edge<2048>(sc, qq, tt, o, B, rcap, tcap, backward, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Base case: banded DP over <= BASE_ROWS rows with moves, then traceback.
// scal i32[B,4]; q u8[B,BASE_ROWS]; t u8[B,tcap]; ops i32[B,n_ops] (reverse
// order); cnt, ok, dist i32[B]; moves u8[B,BASE_ROWS,K] scratch.
int rt_base_launch(const void* scal, const void* q, const void* t, void* ops,
                   void* cnt, void* ok, void* dist, void* moves, int B, int K,
                   int tcap, int n_ops, void* stream) {
  auto s = (cudaStream_t)stream;
  auto sc = (const int*)scal;
  auto qq = (const uint8_t*)q;
  auto tt = (const uint8_t*)t;
  auto op = (int*)ops;
  auto cn = (int*)cnt;
  auto okp = (int*)ok;
  auto di = (int*)dist;
  auto mv = (uint8_t*)moves;
  switch (K) {
    case 256: return launch_base<256>(sc, qq, tt, op, cn, okp, di, mv, B, tcap, n_ops, s);
    case 512: return launch_base<512>(sc, qq, tt, op, cn, okp, di, mv, B, tcap, n_ops, s);
    case 1024: return launch_base<1024>(sc, qq, tt, op, cn, okp, di, mv, B, tcap, n_ops, s);
    case 2048: return launch_base<2048>(sc, qq, tt, op, cn, okp, di, mv, B, tcap, n_ops, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
