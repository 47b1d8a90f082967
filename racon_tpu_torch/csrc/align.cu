// Hirschberg banded global aligner: the edge-row kernel.
//
// Replaces the JAX package's Pallas kernel _build_edge_kernel
// (racon_tpu/ops/align_pallas.py:112). Semantics are those of the plain
// version in ops/align_cuda.py (edge_rows_plain), bit for bit. The base
// case (_build_base_kernel, :299) is csrc/align_base.cu.
//
// Layout: one warp per task. Lane o of the K-wide band row lives in
// thread o / PER, register slot o % PER (PER = K / 32 contiguous lanes per
// thread: 4 at K = 128, the banded path's narrowest bucket, up to 64 at
// K = 2048), so a DP row needs no shared memory and no block barrier: the
// one-lane neighbour crosses threads by one shuffle, and the in-row gap
// pass is a per-thread serial prefix (suffix) min followed by a warp
// shuffle scan of the thread totals.
//
// What bounds it on an H100: integer operations and the serial row
// dependency (R rows of K lanes; up to 49,152 rows a task). A design that
// loads a target byte per lane cell is held by L1 instead: at K = 2048 one
// warp load of a register slot touches 16 lines, about 1,024 L1 wavefronts
// a row. This design takes every load and every bounds test off the row
// and leaves about five SASS instructions a lane cell (a byte permute, an
// add, a three-input min, a min, and the per-word mismatch and slide
// work); what is left above the operation bound is the row's fixed cost
// (nine shuffles and the thread's serial scan) and the lanes out of band,
// which it runs all the same:
// * Target codes in registers, four to a 32-bit word: each thread loads
//   its PER-code window once a task; each row slides it by one code (a
//   funnel shift per word, and one shuffle that brings the code crossing
//   from the next thread). The code entering the band's edge lane (K - 1
//   forward, 0 backward) comes from a coalesced load of the next 32
//   entering codes, one a lane, made 32 rows ahead, and rides the same
//   shuffle. Indices outside [0, tcap) read as 255.
// * Query codes in registers: lane l holds word l of the current 128-code
//   chunk (one coalesced 128-byte load per 128 rows, the next chunk
//   loaded 128 rows ahead; the backward pass walks the chunks downwards).
//   A row's code is one shuffle and one byte permute.
// * Mismatch flags without a per-cell compare: x = window ^ code (the code
//   broadcast to four bytes), and bit 7 of each byte of
//   ((x & 0x7f7f7f7f) + 0x7f7f7f7f) | x is set where the byte differs
//   (three operations a word); a byte permute that replicates that bit
//   gives each lane -1 (mismatch) or 0.
// * The row in a shifted frame: a thread keeps w = row - o - 2 s going
//   forward (row - (K - 1 - o) - 2 s backward) after s rows, so a cell is
//   c = min(w[o] + mismatch - 2, w[o +- 1]), the running min of c, and
//   the min with the thread's exclusive scan value: no per-lane constant.
// * Bounds tested once a task, not once a cell. In-band lanes (column j =
//   i + dmin + o in [0, S]) read only in-band lanes of the row before
//   (columns j - 1 and j) and, through the scan, lanes on the side of
//   column 0 going forward (S backward). Those "behind" lanes start at INF
//   and only take mins of such lanes plus amounts >= 0, so they stay >=
//   INF and never win a scan (an in-band value is at most R + S); the lanes
//   past the other edge never feed the band. So the kernel computes every
//   lane without a mask and sets the lanes out of band to INF once, at
//   the output. The plain version's boundary cell (V = i at column 0
//   going forward, V = R - i at column S backward) is what the recurrence
//   gives there by itself (its neighbour in the row before holds i - 1,
//   resp. R - i - 1, and its diagonal is behind the edge), except where
//   that neighbour lies outside the K lanes: then the edge thread's
//   missing neighbour takes that value for the one row. The plain
//   version's INF clamp never changes an in-band value, which is at most
//   R + S; the values stay far inside int32.
//
// Timers: lane 0 of each warp counts clock64() cycles over the row loop,
// written to cycles[task] when the caller passes that buffer.
//
// C interface (ctypes): every launch function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define INF_ (1 << 28)
#define WARPS 4
#define FULL 0xffffffffu

namespace {

// min(v of lanes 0 .. lane - 1); INT_MAX on lane 0
__device__ __forceinline__ int warp_excl_prefix_min(int v, int lane) {
  int e = __shfl_up_sync(FULL, v, 1);
  if (lane == 0) e = INT_MAX;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) e = min(e, __shfl_up_sync(FULL, e, d));
  return e;
}

// min(v of lanes lane + 1 .. 31); INT_MAX on lane 31
__device__ __forceinline__ int warp_excl_suffix_min(int v, int lane) {
  int e = __shfl_down_sync(FULL, v, 1);
  if (lane == 31) e = INT_MAX;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) e = min(e, __shfl_down_sync(FULL, e, d));
  return e;
}

// -1 where bit 7 of byte b of h is set, else 0 (a byte permute that
// replicates that bit; b is a constant once the cell loop is unrolled)
__device__ __forceinline__ int byte_sign(uint32_t h, int b) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(h), "r"(0u), "r"((8 | b) * 0x1111));
  return r;
}

// bit 7 of each byte set where that byte of a differs from b's
__device__ __forceinline__ uint32_t differs4(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  return ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x;
}

__device__ __forceinline__ uint32_t tcode(const uint8_t* t, int idx,
                                          int tcap) {
  return (idx >= 0 && idx < tcap) ? (uint32_t)__ldg(t + idx) : 255u;
}

template <int K, bool BACKWARD>
__global__ void __launch_bounds__(32 * WARPS, 4)
    edge_kernel(const int* __restrict__ scal, const uint8_t* __restrict__ q,
                const uint8_t* __restrict__ t, int* __restrict__ out,
                long long* __restrict__ cycles, int B, int rcap, int tcap) {
  constexpr int PER = K / 32;       // band lanes a thread
  constexpr int TW = PER / 4;       // target code words a thread
  static_assert(PER % 4 == 0 && PER <= 64, "K in 128..2048");
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= B) return;  // whole warp leaves together
  const int R = scal[task * 4 + 0];
  const int S = scal[task * 4 + 1];
  const int dmin = scal[task * 4 + 2];
  const uint32_t* q32 =
      reinterpret_cast<const uint32_t*>(q + (size_t)task * rcap);
  const int qwords = rcap >> 2;
  const uint8_t* tt = t + (size_t)task * tcap;
  const int o0 = lane * PER;

  // lane l holds word l of the query's 128-code chunk c
  auto qchunk = [&](int c) -> uint32_t {
    const int k = c * 32 + lane;
    return (c >= 0 && k < qwords) ? __ldg(q32 + k) : 0u;
  };
  // lane l holds the code that enters the window after row r = 32 b + l:
  // forward t[r + dmin + K] (lane K - 1 of row r + 1), backward
  // t[r - 1 + dmin] (lane 0 of row r - 1)
  auto enter = [&](int b) -> uint32_t {
    const int r = b * 32 + lane;
    return tcode(tt, BACKWARD ? r - 1 + dmin : r + dmin + K, tcap);
  };

  // the target window of the first row: code p of this thread is
  // t[i + dmin + o0 + p] with i = 0 forward (the row's column j - 1),
  // i = R - 1 backward (column j)
  const int tbase = (BACKWARD ? R - 1 : 0) + dmin + o0;
  uint32_t tw[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      v |= tcode(tt, tbase + 4 * k + b, tcap) << (8 * b);
    tw[k] = v;
  }

  // row 0 (forward, F[0][j] = j) or row R (backward, B[R][j] = S - j) in
  // the shifted frame, s = 0
  int w[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int o = o0 + p;
    const int j = (BACKWARD ? R : 0) + dmin + o;
    const bool in = j >= 0 && j <= S;
    w[p] = BACKWARD ? (in ? S - j : INF_) - (K - 1 - o)
                    : (in ? j : INF_) - o;
  }

  // the edge thread (31 forward, 0 backward) has no neighbour past the
  // band: it reads INF there, except at the step s_star whose boundary
  // cell sits on its edge lane, where it reads that cell's neighbour
  const int edge = BACKWARD ? 0 : 31;
  const int s_star = BACKWARD ? R - 1 - S + dmin : -dmin - K;
  // byte permute that slides the entering code into the edge word:
  // forward tw[TW - 1] takes it as its top byte, backward tw[0] as its
  // low byte; the edge thread's code is byte 1 of the shuffled value
  const uint32_t in_sel = BACKWARD ? (lane == 0 ? 0x2105u : 0x2104u)
                                   : (lane == 31 ? 0x5321u : 0x4321u);

  const int nblk = (R + 31) >> 5;
  const int blk0 = BACKWARD ? nblk - 1 : 0;
  int cq = blk0 >> 2;
  uint32_t qw = qchunk(cq), qw_next = qchunk(BACKWARD ? cq - 1 : cq + 1);
  uint32_t ent_next = enter(blk0);
  const long long t_start = clock64();
  for (int bi = 0; bi < nblk; ++bi) {
    const int blk = BACKWARD ? nblk - 1 - bi : bi;
    const uint32_t ent = ent_next;
    ent_next = enter(BACKWARD ? blk - 1 : blk + 1);
    if ((blk >> 2) != cq) {
      cq = blk >> 2;
      qw = qw_next;
      qw_next = qchunk(BACKWARD ? cq - 1 : cq + 1);
    }
    const int lo = blk * 32, hi = min(R, lo + 32);
    for (int r = BACKWARD ? hi - 1 : lo; BACKWARD ? r >= lo : r < hi;
         BACKWARD ? --r : ++r) {
      const int s = BACKWARD ? R - 1 - r : r;
      // query code r, in all four bytes
      const uint32_t qword = __shfl_sync(FULL, qw, (r >> 2) & 31);
      const uint32_t qc4 = __byte_perm(qword, 0u, (r & 3) * 0x1111u);
      // the code crossing from the neighbour thread (byte 0) and, for
      // the edge thread, the entering code (byte 1)
      const uint32_t src =
          (BACKWARD ? tw[TW - 1] >> 24 : tw[0] & 0xffu) | (ent << 8);
      const int from = lane == edge ? (r & 31) : lane + (BACKWARD ? -1 : 1);
      const uint32_t sh = __shfl_sync(FULL, src, from);
      int nb = BACKWARD ? __shfl_up_sync(FULL, w[PER - 1], 1)
                        : __shfl_down_sync(FULL, w[0], 1);
      if (lane == edge) nb = s == s_star ? -K - s : INF_ - K - 2 * s;

      // the cells in scan order (lanes up forward, down backward): c is
      // the diagonal (w + mismatch - 2 in the shifted frame) or the same
      // column in the row before (the next lane's w), then the thread's
      // running min
      int run = 0;
      uint32_t h = 0;
#pragma unroll
      for (int n = 0; n < PER; ++n) {
        const int p = BACKWARD ? PER - 1 - n : n;
        if (n % 4 == 0) h = differs4(tw[p / 4], qc4);
        const int c = min(w[p] - byte_sign(h, p % 4) - 2,
                          n + 1 < PER ? w[BACKWARD ? p - 1 : p + 1] : nb);
        run = n == 0 ? c : min(run, c);
        w[p] = run;
      }
      const int excl = BACKWARD ? warp_excl_suffix_min(run, lane)
                                : warp_excl_prefix_min(run, lane);
#pragma unroll
      for (int p = 0; p < PER; ++p) w[p] = min(w[p], excl);
      // slide the target window by one code
      if (!BACKWARD) {
#pragma unroll
        for (int k = 0; k + 1 < TW; ++k)
          tw[k] = __funnelshift_r(tw[k], tw[k + 1], 8);
        tw[TW - 1] = __byte_perm(tw[TW - 1], sh, in_sel);
      } else {
#pragma unroll
        for (int k = TW - 1; k > 0; --k)
          tw[k] = __funnelshift_l(tw[k - 1], tw[k], 8);
        tw[0] = __byte_perm(tw[0], sh, in_sel);
      }
    }
  }
  if (cycles != nullptr && lane == 0) cycles[task] = clock64() - t_start;

  // back to row values; lanes out of band at the last row are INF
  const int jlast = (BACKWARD ? 0 : R) + dmin + o0;
  int v[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int o = o0 + p;
    const int j = jlast + p;
    v[p] = (j >= 0 && j <= S) ? w[p] + 2 * R + (BACKWARD ? K - 1 - o : o)
                              : INF_;
  }
  int4* dst = reinterpret_cast<int4*>(out + (size_t)task * K + o0);
#pragma unroll
  for (int k = 0; k < PER / 4; ++k)
    dst[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

template <int K>
cudaError_t launch_edge(const int* scal, const uint8_t* q, const uint8_t* t,
                        int* out, long long* cycles, int B, int rcap,
                        int tcap, int backward, cudaStream_t s) {
  dim3 grid((B + WARPS - 1) / WARPS), block(32 * WARPS);
  if (backward)
    edge_kernel<K, true><<<grid, block, 0, s>>>(scal, q, t, out, cycles, B,
                                                 rcap, tcap);
  else
    edge_kernel<K, false><<<grid, block, 0, s>>>(scal, q, t, out, cycles, B,
                                                  rcap, tcap);
  return cudaGetLastError();
}

template <int K, bool BACKWARD>
cudaError_t occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, edge_kernel<K, BACKWARD>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, edge_kernel<K, BACKWARD>, 32 * WARPS, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks * WARPS;
  return err;
}

template <int K>
cudaError_t occupancy_dir(int backward, int* out) {
  return backward ? occupancy<K, true>(out) : occupancy<K, false>(out);
}

}  // namespace

extern "C" {

// Last band row of the forward (backward) DP per task.
// scal i32[B,4] = (R, S, dmin, 0); q u8[B,rcap] (4-byte aligned, rcap a
// multiple of 4: read as 32-bit words); t u8[B,tcap]; out i32[B,K]
// (16-byte aligned); cycles i64[B] (the row loop's clock64() cycles a
// task) or null.
int rt_edge_launch(const void* scal, const void* q, const void* t, void* out,
                   void* cycles, int B, int rcap, int K, int tcap,
                   int backward, void* stream) {
  auto s = (cudaStream_t)stream;
  auto sc = (const int*)scal;
  auto qq = (const uint8_t*)q;
  auto tt = (const uint8_t*)t;
  auto o = (int*)out;
  auto cy = (long long*)cycles;
  switch (K) {
    case 128: return launch_edge<128>(sc, qq, tt, o, cy, B, rcap, tcap, backward, s);
    case 256: return launch_edge<256>(sc, qq, tt, o, cy, B, rcap, tcap, backward, s);
    case 512: return launch_edge<512>(sc, qq, tt, o, cy, B, rcap, tcap, backward, s);
    case 1024: return launch_edge<1024>(sc, qq, tt, o, cy, B, rcap, tcap, backward, s);
    case 2048: return launch_edge<2048>(sc, qq, tt, o, cy, B, rcap, tcap, backward, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The kernel's registers a thread, local (spill) bytes a thread and
// resident warps per SM at band K and direction; out[3].
int rt_edge_occupancy(int K, int backward, int* out) {
  switch (K) {
    case 128: return (int)occupancy_dir<128>(backward, out);
    case 256: return (int)occupancy_dir<256>(backward, out);
    case 512: return (int)occupancy_dir<512>(backward, out);
    case 1024: return (int)occupancy_dir<1024>(backward, out);
    case 2048: return (int)occupancy_dir<2048>(backward, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
