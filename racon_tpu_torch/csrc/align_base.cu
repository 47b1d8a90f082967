// Hirschberg base case: banded DP over <= BASE_ROWS rows with one move per
// cell, then the traceback from (R, S) to (0, 0).
//
// Replaces the JAX package's Pallas kernel _build_base_kernel
// (racon_tpu/ops/align_pallas.py:299). Semantics are those of the plain
// version base_plain in ops/align_cuda.py, bit for bit: the same ops, cnt,
// ok and dist for every task.
//
// Layout: one warp per task. Lane o of the K-wide band row lives in thread
// o / PER, register slot o % PER (PER = K / 32 contiguous lanes a thread:
// 4 at K = 128, the banded path's narrowest bucket, where a thread holds
// one word of target codes), so a DP row needs no shared memory and no
// block barrier.
//
// What bounds it on an H100: integer operations (about 20 a cell) and the
// serial row dependency. The design keeps everything but the moves in
// registers and moves as few bytes as it can:
// * Two int32 arrays a thread: the row's values x[p] and their in-row scan
//   c[p] = V - o (per-thread serial prefix min, then a warp shuffle scan of
//   the thread totals). The M/I bit is kept in a mask.
// * Target codes in registers, four to a 32-bit word: the thread loads its
//   window once; each row slides it by one code (a funnel shift per word
//   and one shuffle for the code that enters from the next thread; lane 31
//   loads the one new code, prefetched a row ahead). A word's four
//   mismatch bits come from one __vcmpne4 against the query code.
// * Query codes in registers: lane l holds bytes 4l..4l+3 and 128+4l..; a
//   row's code is one shuffle away.
// * Moves packed, two bits a cell, and stored coalesced: a row is K/4
//   bytes; thread `lane` writes its PER/4 bytes at lane * PER/4 with one
//   store (at K = 128 the even thread of each pair stores both threads'
//   byte pair). Lane o's move sits in the byte pair 2*(o/8), 2*(o/8)+1: bit
//   o%8 of the first byte is set for I, of the second for D (M: neither).
// The traceback runs on lane 0 and keeps the last 32-bit word it loaded,
// reloading only when the row or the word changes (a run of D moves costs
// no load).
//
// The values: in-band cells hold at most R + S; out-of-band cells hold
// INF = 1 << 28 exactly (an in-band cell's diagonal predecessor is in band,
// so it never takes INF + 1). So V - o <= INF on every lane, and the
// Pallas scan's INF clamp (every lane but the last) never changes a value;
// the kernel applies it all the same, as base_plain does. Out-of-band
// lanes still run the row (the warp runs all K lanes); at K >= 1024 they
// are most of a base task's lanes, since a task spans at most R + S + 1
// of them.
//
// Timers: lane 0 of each warp counts clock64() cycles for the DP rows and
// for the traceback (with the ops zero-fill), written to cycles[0, task]
// and cycles[1, task] when the caller passes that buffer.
//
// C interface (ctypes): every launch function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define INF_ (1 << 28)
#define BASE_ROWS 256
#define WARPS 4
#define FULL 0xffffffffu

namespace {

__device__ __forceinline__ int warp_prefix_min(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = min(v, o);
  }
  return v;
}

__device__ __forceinline__ uint32_t tcode(const uint8_t* t, int idx,
                                          int tcap) {
  return (idx >= 0 && idx < tcap) ? (uint32_t)__ldg(t + idx) : 255u;
}

// One thread's packed moves of a row: PER/16 32-bit words (16 bits at
// PER = 8), byte pairs (I bits, D bits) of 8 lanes each. At PER = 4 (K =
// 128) a byte pair spans two threads: every thread takes its odd
// neighbour's 4 + 4 bits by one shuffle, and the even thread stores the
// pair at its own offset (2 * (lane / 2) bytes: a row is 32 bytes).
template <int PER>
__device__ __forceinline__ void store_moves(uint8_t* dst, const uint32_t* I,
                                            const uint32_t* D, int lane) {
  if constexpr (PER == 4) {
    const uint32_t mine = (I[0] & 0xfu) | ((D[0] & 0xfu) << 8);
    const uint32_t odd = __shfl_down_sync(FULL, mine, 1);
    if ((lane & 1) == 0)
      *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(mine | (odd << 4));
  } else if constexpr (PER == 8) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(I[0] | (D[0] << 8));
  } else {
    uint32_t w[PER / 16];
#pragma unroll
    for (int h = 0; h < PER / 16; ++h) {
      const int k = h / 2, sh = (h % 2) * 16;
      w[h] = __byte_perm(I[k] >> sh, D[k] >> sh, 0x5140);
    }
    if constexpr (PER == 16) {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    } else if constexpr (PER == 32) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(32 * WARPS)
    base_kernel(const int* __restrict__ scal, const uint8_t* __restrict__ q,
                const uint8_t* __restrict__ t, int* __restrict__ ops,
                int* __restrict__ cnt_out, int* __restrict__ ok_out,
                int* __restrict__ dist_out, uint8_t* __restrict__ moves,
                long long* __restrict__ cycles, int B, int tcap, int n_ops) {
  constexpr int PER = K / 32;       // band lanes a thread
  constexpr int TW = PER / 4;       // target code words a thread
  constexpr int NM = (PER + 31) / 32;
  constexpr int ROWB = K / 4;       // bytes of packed moves a row
  static_assert(PER % 4 == 0 && PER <= 64, "K in 128..2048");
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= B) return;  // whole warp leaves together
  const long long t_start = clock64();
  const int R = scal[task * 4 + 0];
  const int S = scal[task * 4 + 1];
  const int dmin = scal[task * 4 + 2];
  const uint8_t* qt = q + (size_t)task * BASE_ROWS;
  const uint8_t* tt = t + (size_t)task * tcap;
  uint8_t* mvs = moves + (size_t)task * BASE_ROWS * ROWB;
  const int o0 = lane * PER;

  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qt);
  const uint32_t qw0 = __ldg(q32 + lane), qw1 = __ldg(q32 + 32 + lane);

  // code p of this thread is the target at row i's column jv - 1 =
  // (i - 1) + dmin + o0 + p
  uint32_t tw[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w |= tcode(tt, dmin + o0 + 4 * k + b, tcap) << (8 * b);
    tw[k] = w;
  }

  int x[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j0 = dmin + o0 + p;
    x[p] = (j0 >= 0 && j0 <= S) ? j0 : INF_;
  }
  const int rows = min(R, BASE_ROWS);
  for (int i = 1; i <= rows; ++i) {
    const int r = i - 1;
    const uint32_t qword = __shfl_sync(FULL, r < 128 ? qw0 : qw1,
                                       (r >> 2) & 31);
    const uint32_t qc4 = ((qword >> ((r & 3) * 8)) & 0xffu) * 0x01010101u;
    // the code that enters lane K - 1 for row i + 1
    const uint32_t enter = lane == 31 ? tcode(tt, i + dmin + K - 1, tcap) : 0u;
    int nb = __shfl_down_sync(FULL, x[0], 1);
    if (lane == 31) nb = INF_;
    const int jb = i + dmin + o0;
    uint32_t im[NM], dm[NM];
#pragma unroll
    for (int w = 0; w < NM; ++w) im[w] = dm[w] = 0;
    int c[PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int jv = jb + p;
      const uint32_t mm = (__vcmpne4(tw[p / 4], qc4) >> (8 * (p % 4))) & 1u;
      const int up = (p + 1 < PER ? x[p + 1] : nb) + 1;
      const int sub = x[p] + (int)mm;
      int V = min(sub, up);
      bool m1 = up < sub;
      if (jv == 0) {
        V = i;
        m1 = true;
      }
      if (jv < 0 || jv > S) V = INF_;
      if (m1) im[p / 32] |= 1u << (p % 32);
      x[p] = V;
      c[p] = V - (o0 + p);
    }
#pragma unroll
    for (int p = 1; p < PER; ++p) c[p] = min(c[p], c[p - 1]);
    int excl = __shfl_up_sync(FULL, warp_prefix_min(c[PER - 1], lane), 1);
    if (lane == 0) excl = INT_MAX;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int o = o0 + p;
      const int jv = jb + p;
      int cc = min(c[p], excl);
      // the Pallas scan's INF fill reaches every lane but the last
      if (p < PER - 1 || lane < 31) cc = min(cc, INF_);
      const int nrow = cc + o;
      if (nrow < x[p]) dm[p / 32] |= 1u << (p % 32);
      x[p] = (jv < 0 || jv > S) ? INF_ : nrow;
    }
#pragma unroll
    for (int w = 0; w < NM; ++w) im[w] &= ~dm[w];
    store_moves<PER>(mvs + (size_t)r * ROWB + lane * (PER / 4), im, dm,
                     lane);
    // slide the target window by one code
    uint32_t in = __shfl_down_sync(FULL, tw[0], 1);
    if (lane == 31) in = enter;
#pragma unroll
    for (int k = 0; k + 1 < TW; ++k) tw[k] = __funnelshift_r(tw[k], tw[k + 1], 8);
    tw[TW - 1] = __funnelshift_r(tw[TW - 1], in, 8);
  }

  // terminal distance DP[R][S]
  const int o_fin = S - R - dmin;
  if (o_fin >= o0 && o_fin < o0 + PER) {
#pragma unroll
    for (int p = 0; p < PER; ++p)
      if (o0 + p == o_fin) dist_out[task] = x[p];
  } else if (lane == 0 && (o_fin < 0 || o_fin >= K)) {
    dist_out[task] = INF_;
  }
  __syncwarp();  // the row moves are visible to lane 0
  const long long t_dp = clock64();

  int* optr = ops + (size_t)task * n_ops;
  int cnt = 0;
  if (lane == 0) {
    const uint32_t* mw = reinterpret_cast<const uint32_t*>(mvs);
    int i = R, j = S, key = -1;
    uint32_t w = 0;
    bool ok = true;
    while ((i > 0 || j > 0) && cnt < n_ops && ok) {
      const int o = j - i - dmin;
      int mv;
      if (i > 0) {
        if (o >= 0 && o < K && i <= BASE_ROWS) {
          const int k = (i - 1) * (ROWB / 4) + (o >> 4);
          if (k != key) {
            w = mw[k];
            key = k;
          }
          const int sh = (o & 8) * 2 + (o & 7);
          mv = ((w >> sh) & 1u) | (((w >> (sh + 8)) & 1u) << 1);
        } else {
          mv = 3;
        }
      } else {
        mv = 2;
      }
      ok = mv != 3;
      optr[cnt] = mv;
      if (mv != 2) --i;
      if (mv != 1) --j;
      ++cnt;
    }
    cnt_out[task] = cnt;
    ok_out[task] = (ok && i == 0 && j == 0) ? 1 : 0;
  }
  cnt = __shfl_sync(FULL, cnt, 0);
  for (int k = cnt + lane; k < n_ops; k += 32) optr[k] = 0;
  if (cycles != nullptr && lane == 0) {
    cycles[task] = t_dp - t_start;
    cycles[(size_t)B + task] = clock64() - t_dp;
  }
}

template <int K>
cudaError_t launch_base(const int* scal, const uint8_t* q, const uint8_t* t,
                        int* ops, int* cnt, int* ok, int* dist,
                        uint8_t* moves, long long* cycles, int B, int tcap,
                        int n_ops, cudaStream_t s) {
  dim3 grid((B + WARPS - 1) / WARPS), block(32 * WARPS);
  base_kernel<K><<<grid, block, 0, s>>>(scal, q, t, ops, cnt, ok, dist,
                                        moves, cycles, B, tcap, n_ops);
  return cudaGetLastError();
}

template <int K>
cudaError_t occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, base_kernel<K>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, base_kernel<K>,
                                                      32 * WARPS, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks * WARPS;
  return err;
}

}  // namespace

extern "C" {

// Base case: banded DP over <= BASE_ROWS rows with moves, then traceback.
// scal i32[B,4]; q u8[B,BASE_ROWS] (4-byte aligned); t u8[B,tcap]; ops
// i32[B,n_ops] (reverse order); cnt, ok, dist i32[B]; moves
// u8[B,BASE_ROWS,K/4] scratch (16-byte aligned); cycles i64[2,B] or null.
int rt_base_launch(const void* scal, const void* q, const void* t, void* ops,
                   void* cnt, void* ok, void* dist, void* moves, void* cycles,
                   int B, int K, int tcap, int n_ops, void* stream) {
  auto s = (cudaStream_t)stream;
  auto sc = (const int*)scal;
  auto qq = (const uint8_t*)q;
  auto tt = (const uint8_t*)t;
  auto op = (int*)ops;
  auto cn = (int*)cnt;
  auto okp = (int*)ok;
  auto di = (int*)dist;
  auto mv = (uint8_t*)moves;
  auto cy = (long long*)cycles;
  switch (K) {
    case 128: return launch_base<128>(sc, qq, tt, op, cn, okp, di, mv, cy, B, tcap, n_ops, s);
    case 256: return launch_base<256>(sc, qq, tt, op, cn, okp, di, mv, cy, B, tcap, n_ops, s);
    case 512: return launch_base<512>(sc, qq, tt, op, cn, okp, di, mv, cy, B, tcap, n_ops, s);
    case 1024: return launch_base<1024>(sc, qq, tt, op, cn, okp, di, mv, cy, B, tcap, n_ops, s);
    case 2048: return launch_base<2048>(sc, qq, tt, op, cn, okp, di, mv, cy, B, tcap, n_ops, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The kernel's registers a thread, local (spill) bytes a thread and
// resident warps per SM at band K; out[3].
int rt_base_occupancy(int K, int* out) {
  switch (K) {
    case 128: return (int)occupancy<128>(out);
    case 256: return (int)occupancy<256>(out);
    case 512: return (int)occupancy<512>(out);
    case 1024: return (int)occupancy<1024>(out);
    case 2048: return (int)occupancy<2048>(out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
