// DP-cost probe: 19 stripped-down DP loop shapes, one thread block per
// program, each returning a seed-dependent `out` and a measured count of
// serial steps or DP cells.
//
// Replaces the JAX package's probe kernels build(mode, R, B)
// (racon_tpu/tools/dp_cost_probe.py:89, pallas_call :602). Every mode
// computes the same `out` and `steps` as the Pallas probe, including the
// modes whose arithmetic was a TPU layout experiment (no cross-sublane
// carry, flat row, paired rows, the lockstep ring, the windowed ring); the
// plain PyTorch versions in tools/dp_cost_probe.py repeat that arithmetic.
// On the card each mode measures what its Hopper shape costs a serial row
// step (tools/dp_cost_probe.py's docstring names it per mode). What bounds
// each mode on an H100 is that serial chain of rows (shuffles, barriers,
// dependent loads), not bytes or integer throughput.
//
// The rows are those of the POA kernels since their redesigns (csrc/poa.cu,
// the banded builds of csrc/poa_v2.cu): the row before lives in the
// registers of the threads that own its columns, and the cell left of a
// thread's first column is that row's running max there, the thread's own
// exclusive scan value, so no thread reads a cell another wrote in the row
// just finished; the block scan takes one barrier a row, its warp totals
// alternating between two buffers (block_excl); the graph tables, in_src
// included, live in shared memory; a predecessor further back than the row
// before comes from a shared ring of rows; a program writes its rows to the
// global scratch only where the caller reads them: the last row (or ring
// row), which `out` is made of and the wrapper returns with rows=True.
// By shape:
//   * modes 0-5, 7, 11: a 1,024-column row, 256 threads of 4 contiguous
//     columns: a per-thread max, a warp shuffle scan, the 8 warp totals
//     through shared memory, one barrier. A TPU sublane of 128 columns is
//     one warp here, so mode 5 (no cross-sublane carry) runs each warp on
//     its own, with no barrier. Modes 3 and 4 read their predecessors (the
//     synthetic graph's ranks u - 1 and u - 2) from the registers and from
//     a shared ring of the last rows.
//   * mode 6: the same row on 1,024 threads of one column each;
//   * mode 8: two rows per thread per step (ILP), one barrier for both;
//   * modes 9, 10, 12: eight 512-column windows per block, one warp each,
//     16 columns per lane, no barrier; mode 10's older rows (up to four
//     back) in a shared ring of four rows a window;
//   * modes 13-16: a band row carried in registers (one warp for 128
//     columns, a block for 1,024 with the shift's carry across warps
//     through shared memory, one barrier a row);
//   * modes 17, 18: a 1,664- or 512-column window of an 8-row ring; mode
//     17's window is the whole row, kept in registers; mode 18's moves
//     along the row, so its ring lives in shared memory, and a row whose
//     window moved reads the ring after a barrier of its own.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define NEG_ (-(1 << 28))
#define G_ (-8)
#define NSLOT 2048   // node slots: the TPU probe's (8, 256) node tile
#define NE 12        // in-edge slots
#define ROW 1024     // flat DP row: the TPU probe's (8, 128) row
#define LS_W 512     // lockstep window row: (4, 128)
#define LS_G 8       // lockstep windows per program
#define RING 128     // lockstep ring rows
#define GSLOTS 16    // lockstep graph-row slots (mode 10)
#define JC2 13       // banded-POA flat row chunks of 128 (modes 17/18)
#define CB 4         // banded-POA window chunks (mode 18)
#define RING2 8      // banded-POA ring rows

namespace {

__device__ __forceinline__ int sc_of(int j, int ub) {
  return (j & 3) == ub ? 5 : -4;
}

__device__ __forceinline__ int warp_scan_bin(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

// Radix-4 inclusive max-scan: rounds of three independent shifted copies,
// tree-combined (3 rounds instead of 5, the same work).
__device__ __forceinline__ int warp_scan_r4(int v, int lane) {
  for (int w = 1; w < 32; w *= 4) {
    const int a = __shfl_up_sync(FULL, v, w);
    const int b = __shfl_up_sync(FULL, v, 2 * w);
    const int c = __shfl_up_sync(FULL, v, 3 * w);
    const int a2 = lane >= w ? a : INT_MIN;
    const int b2 = (2 * w < 32 && lane >= 2 * w) ? b : INT_MIN;
    const int c2 = (3 * w < 32 && lane >= 3 * w) ? c : INT_MIN;
    v = max(max(v, a2), max(b2, c2));
  }
  return v;
}

// Exclusive prefix max of the threads' totals over the block (INT_MIN for
// thread 0), behind one barrier: the warp totals go to red, which the
// caller alternates between two buffers from row to row, so that no second
// barrier protects them.
template <bool R4>
__device__ __forceinline__ int block_excl(int tot, int* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int inc = R4 ? warp_scan_r4(tot, lane) : warp_scan_bin(tot, lane);
  if (lane == 31) red[wid] = inc;
  int ex = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) ex = INT_MIN;
  __syncthreads();
  for (int q = 0; q < wid; ++q) ex = max(ex, red[q]);
  return ex;
}

// ---- modes 0-5, 7, 11: the POA row on a 1,024-column row ---------------

#define RA 4         // shared ring slots of modes 3 and 4: rank q in q % RA;
                     // ranks r - 2 .. r - 4 readable at rank r

struct Graph {
  int* order;
  int* base;
  float* key;
  int* in_cnt;
  int* has_out;
  int16_t* in_src;  // [NE][NSLOT]
  int* ring;        // [RA][ROW]: the rows of the last ranks (modes 3, 4)
};

// Dynamic shared bytes of probe_a<MODE>: the warp totals' two buffers, the
// graph (level 1 and up), in_src and the ring (level 3 and up).
__host__ __device__ constexpr size_t probe_a_smem(int level) {
  return 2 * 8 * sizeof(int) +
         (level >= 1 ? 5 * NSLOT * sizeof(int) : 0) +
         (level >= 3 ? NE * NSLOT * sizeof(int16_t) + RA * ROW * sizeof(int)
                     : 0);
}

// One rank's row: from the row before (prow at the thread's columns, pleft
// at column j0 - 1) or, at level 3 and up, the rank's predecessors (the
// row before, or the ring), into prow and pleft; par picks the warp
// totals' buffer.
template <int MODE>
__device__ __forceinline__ void row_a(int r, int sd, const Graph& g,
                                      int* red, int par, int* prow,
                                      int& pleft) {
  constexpr int LEVEL =
      (MODE == 5 || MODE == 7) ? 0 : (MODE == 11 ? 1 : MODE);
  const int tid = threadIdx.x, lane = tid & 31;
  const int j0 = tid * 4;
  const int u = LEVEL >= 1 ? g.order[r] : r;
  int ub = 1, cnt = 0;
  if (LEVEL >= 2) { ub = g.base[u]; cnt = g.in_cnt[u]; }
  // P[k] is column j0 - 1 + k
  int P[5];
  bool any = false;
  if (LEVEL >= 3) {
    // the row of rank r - 1 goes to the ring for the ranks after
    int* slot = g.ring + ((r - 1) & (RA - 1)) * ROW;
#pragma unroll
    for (int k = 0; k < 4; ++k) slot[j0 + k] = prow[k];
#pragma unroll
    for (int k = 0; k < 5; ++k) P[k] = NEG_;
    for (int e = 0; e < cnt; ++e) {
      const int src = max((int)g.in_src[e * NSLOT + u], 0);
      const bool ok = g.key[src] >= 0.f;
      if (ok) {
        // rank src (order is the identity): the row before, or the ring
        const int d = r - src;
        if (d <= 1) {
          if (j0 > 0) P[0] = max(P[0], pleft);
#pragma unroll
          for (int k = 1; k < 5; ++k) P[k] = max(P[k], prow[k - 1]);
        } else {
          const int* q = g.ring + (src & (RA - 1)) * ROW;
          if (j0 > 0) P[0] = max(P[0], q[j0 - 1]);
#pragma unroll
          for (int k = 1; k < 5; ++k) P[k] = max(P[k], q[j0 + k - 1]);
        }
        if (LEVEL >= 4 && tid == 0) g.has_out[src] = 1;
      }
      any = any || ok;
    }
  }
  if (!any) {
    if (LEVEL >= 3) {  // no valid predecessor: the virtual row 0
      P[0] = j0 > 0 ? (j0 - 1) * G_ + sd : NEG_;
#pragma unroll
      for (int k = 1; k < 5; ++k) P[k] = (j0 + k - 1) * G_ + sd;
    } else {
      P[0] = pleft;
#pragma unroll
      for (int k = 1; k < 5; ++k) P[k] = prow[k - 1];
    }
  }
  int x[4], run = INT_MIN;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = j0 + k;
    const int diag = (j == 0 ? NEG_ : P[k]) + sc_of(j, ub);
    const int V = max(diag, P[k + 1] + G_);
    run = max(run, V - j * G_);
    x[k] = run;
  }
  int ex;
  if (MODE == 5) {  // per-warp scan only: no carry across warps
    const int inc = warp_scan_bin(run, lane);
    ex = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) ex = INT_MIN;
  } else {
    ex = block_excl<MODE == 7>(run, red + par * 8);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) prow[k] = max(x[k], ex) + (j0 + k) * G_;
  if (MODE == 5) {
    // mode 5's shift wraps inside the warp's 128 columns: lane 0 takes
    // column j0 + 127, lane 31's last
    const int wrap = __shfl_sync(FULL, prow[3], 31);
    pleft = lane > 0 ? ex + (j0 - 1) * G_ : j0 > 0 ? wrap : NEG_;
  } else {
    pleft = j0 > 0 ? ex + (j0 - 1) * G_ : NEG_;
  }
}

template <int MODE>
__global__ void __launch_bounds__(256)
probe_a(int R, const int* __restrict__ seed, int* __restrict__ out,
        int* __restrict__ steps, int* __restrict__ scratch, size_t per) {
  constexpr int LEVEL =
      (MODE == 5 || MODE == 7) ? 0 : (MODE == 11 ? 1 : MODE);
  extern __shared__ int sh[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int j0 = tid * 4;
  int* red = sh;  // [2][8]
  Graph g;
  g.order = sh + 16;
  g.base = g.order + NSLOT;
  g.key = (float*)(g.base + NSLOT);
  g.in_cnt = (int*)(g.key + NSLOT);
  g.has_out = g.in_cnt + NSLOT;
  g.in_src = (int16_t*)(g.has_out + NSLOT);
  g.ring = (int*)(g.in_src + NE * NSLOT);
  const int sd = seed[blockIdx.x];
  if (LEVEL >= 1) {
    for (int i = tid; i < NSLOT; i += 256) {
      g.order[i] = i;
      g.base[i] = i % 4;
      g.key[i] = (float)(MODE == 11 ? i / 2 : i);
      g.in_cnt[i] = i > 0 ? 2 : 0;
      g.has_out[i] = 0;
      if (LEVEL >= 3)
        for (int e = 0; e < NE; ++e)
          g.in_src[e * NSLOT + i] =
              (int16_t)(e == 0 ? max(i - 1, 0) : e == 1 ? max(i - 2, 0) : 0);
    }
  }
  // the row before at the thread's columns and at column j0 - 1: row 0,
  // j * G + seed (mode 5's lane 0 wraps to column j0 + 127)
  int prow[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) prow[k] = (j0 + k) * G_ + sd;
  int pleft = j0 == 0 ? NEG_
              : (MODE == 5 && lane == 0) ? (j0 + 127) * G_ + sd
                                         : (j0 - 1) * G_ + sd;
  __syncthreads();
  int it = 0, par = 0;
  if (MODE == 11) {  // the colstep loop: rank r + 1 rides along when it
    for (int r = 0; r < R; ++it) {  // shares rank r's column key
      row_a<MODE>(r, sd, g, red, par, prow, pleft);
      par ^= 1;
      const bool pair =
          r + 1 < R && g.key[g.order[r + 1]] == g.key[g.order[r]];
      if (pair) {
        row_a<MODE>(r + 1, sd, g, red, par, prow, pleft);
        par ^= 1;
      }
      r += pair ? 2 : 1;
    }
  } else {
    for (int r = 0; r < R; ++r, ++it, par ^= 1)
      row_a<MODE>(r, sd, g, red, par, prow, pleft);
  }
  int* last = scratch + (size_t)blockIdx.x * per;
#pragma unroll
  for (int k = 0; k < 4; ++k) last[j0 + k] = prow[k];
  if (tid == 0) {
    out[blockIdx.x] = prow[0] + prow[1];
    steps[blockIdx.x] = it;
  }
}

// ---- mode 6: the same row, one column per thread on 1,024 threads --------

__global__ void __launch_bounds__(1024)
probe_flat(int R, const int* __restrict__ seed, int* __restrict__ out,
           int* __restrict__ steps, int* __restrict__ scratch, size_t per) {
  __shared__ int red[2][32];
  const int j = threadIdx.x;
  const int sd = seed[blockIdx.x];
  int prv = j * G_ + sd;                      // the row before at j
  int pl = j > 0 ? (j - 1) * G_ + sd : NEG_;  // and at j - 1
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    const int diag = (j == 0 ? NEG_ : pl) + sc_of(j, 1);
    const int v = max(diag, prv + G_) - j * G_;
    const int ex = block_excl<false>(v, red[r & 1]);
    prv = max(v, ex) + j * G_;
    pl = j > 0 ? ex + (j - 1) * G_ : NEG_;
  }
  scratch[(size_t)blockIdx.x * per + j] = prv;
  if (j == 0) {
    out[blockIdx.x] = prv;
    steps[blockIdx.x] = R;
  }
}

// ---- mode 8: two independent rows per step ------------------------------

__global__ void __launch_bounds__(256)
probe_pair(int R, const int* __restrict__ seed, int* __restrict__ out,
           int* __restrict__ steps, int* __restrict__ scratch, size_t per) {
  __shared__ int red[2][2][8];  // [row parity][row of the pair][warp]
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int j0 = tid * 4;
  const int sd = seed[blockIdx.x];
  int prow[2][4], pleft[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int k = 0; k < 4; ++k) prow[p][k] = (j0 + k) * G_ + sd;
    pleft[p] = j0 > 0 ? (j0 - 1) * G_ + sd : NEG_;
  }
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    int x[2][4], run[2], ex[2];
    const int par = r & 1;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      run[p] = INT_MIN;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        const int lft = k == 0 ? pleft[p] : prow[p][k - 1];
        const int diag = (j == 0 ? NEG_ : lft) + sc_of(j, 1);
        run[p] = max(run[p], max(diag, prow[p][k] + G_) - j * G_);
        x[p][k] = run[p];
      }
      const int inc = warp_scan_bin(run[p], lane);
      if (lane == 31) red[par][p][wid] = inc;
      ex[p] = __shfl_up_sync(FULL, inc, 1);
      if (lane == 0) ex[p] = INT_MIN;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      for (int q = 0; q < wid; ++q) ex[p] = max(ex[p], red[par][p][q]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        prow[p][k] = max(x[p][k], ex[p]) + (j0 + k) * G_;
      pleft[p] = j0 > 0 ? ex[p] + (j0 - 1) * G_ : NEG_;
    }
  }
  int* last = scratch + (size_t)blockIdx.x * per;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int k = 0; k < 4; ++k) last[p * ROW + j0 + k] = prow[p][k];
  if (tid == 0) {
    out[blockIdx.x] = prow[0][0];
    steps[blockIdx.x] = R;
  }
}

// ---- modes 9, 10, 12: eight lockstep windows, one warp each -------------

#define RL 4         // mode 10's shared ring slots a window: rows r-1..r-4

// One rank's row of one window (a warp): from the row before (prow, and
// pleft at column j0 - 1) and, in mode 10, the older rows of the shared
// ring; into prow and pleft. The ring's row k sits in slot k mod RL (row
// k <= 0 is the lockstep ring's seeding).
template <int MODE>
__device__ __forceinline__ void row_ls(int r, int* ring, const int* gls,
                                       int lane, int* prow, int& pleft) {
  const int j0 = lane * 16;
  int P[17];
  P[0] = pleft;
#pragma unroll
  for (int k = 1; k < 17; ++k) P[k] = prow[k - 1];
  if (MODE == 10) {
    // twelve graph-row loads of 8 values at lane r % 128, summed
    int acc = 0;
    for (int i = lane; i < NE * 8; i += 32) {
      const int e = i >> 3, s = i & 7;
      acc += gls[(((r + e) % GSLOTS) * 8 + s) * 128 + (r % 128)];
    }
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(FULL, acc, d);
    const int nd = acc % 4 + 1;
    for (int d = 1; d <= 4; ++d) {  // depth-4 delta scan over older rows
      if (d <= nd) {
        const int* q = ring + (((r - d) % RL + RL) % RL) * LS_W;
        if (j0 > 0) P[0] = max(P[0], q[j0 - 1]);
#pragma unroll
        for (int k = 1; k < 17; ++k) P[k] = max(P[k], q[j0 + k - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < 17; ++k) P[k] += acc & 1;
    // row r (the row before) replaces row r - 4 once every lane has read
    __syncwarp();
    int* slot = ring + (r % RL) * LS_W;
#pragma unroll
    for (int k = 0; k < 16; ++k) slot[j0 + k] = prow[k];
  }
  int x[16], run = INT_MIN;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int j = j0 + k;
    const int diag = (j == 0 ? NEG_ : P[k]) + sc_of(j, 1);
    run = max(run, max(diag, P[k + 1] + G_) - j * G_);
    x[k] = run;
  }
  const int inc = warp_scan_bin(run, lane);
  int ex = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) ex = INT_MIN;
#pragma unroll
  for (int k = 0; k < 16; ++k) prow[k] = max(x[k], ex) + (j0 + k) * G_;
  pleft = j0 > 0 ? ex + (j0 - 1) * G_ : NEG_;
  if (MODE == 10) __syncwarp();
}

template <int MODE>
__global__ void __launch_bounds__(256)
probe_ls(int R, const int* __restrict__ seed, int* __restrict__ out,
         int* __restrict__ steps, int* __restrict__ scratch, size_t per) {
  extern __shared__ int gls[];  // mode 10: [GSLOTS][8][128], then the rings
  const int tid = threadIdx.x, lane = tid & 31, wnd = tid >> 5;
  const int j0 = lane * 16;
  const int sd = seed[blockIdx.x];
  int* ring = gls + GSLOTS * 8 * 128 + wnd * RL * LS_W;  // mode 10
  if (MODE == 10) {
    for (int i = tid; i < GSLOTS * 8 * 128; i += 256)
      gls[i] = (i % 128 + i / 1024) % 7;
    // rows -1 .. -4: the lockstep ring's seeding of slots 127 .. 124
    for (int d = 1; d <= RL; ++d)
      for (int j = lane; j < LS_W; j += 32)
        ring[((RL - d) % RL) * LS_W + j] = j * G_ + sd - (RING - d);
  }
  // the row before: row 0, the ring's slot 0, j * G + seed
  int prow[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) prow[k] = (j0 + k) * G_ + sd;
  int pleft = j0 > 0 ? (j0 - 1) * G_ + sd : NEG_;
  __syncthreads();
  int it = 0;
  if (MODE == 12) {  // two unconditional ranks per serial iteration
    for (int p = 0; p < (R + 1) / 2; ++p, ++it) {
      row_ls<MODE>(2 * p, ring, gls, lane, prow, pleft);
      if (2 * p + 1 < R) row_ls<MODE>(2 * p + 1, ring, gls, lane, prow, pleft);
    }
  } else {
    for (int r = 0; r < R; ++r, ++it)
      row_ls<MODE>(r, ring, gls, lane, prow, pleft);
  }
  int* last = scratch + (size_t)blockIdx.x * per + wnd * LS_W;
#pragma unroll
  for (int k = 0; k < 16; ++k) last[j0 + k] = prow[k];
  if (tid == 0) {
    out[blockIdx.x] = prow[0] + prow[1];
    steps[blockIdx.x] = it;
  }
}

// ---- modes 13-16: a band row carried in registers -----------------------

template <int MODE>
__global__ void __launch_bounds__(256)
probe_band(int R, const int* __restrict__ seed, int* __restrict__ out,
           int* __restrict__ steps, int* __restrict__ scratch, size_t per) {
  __shared__ int codes[NSLOT];
  __shared__ int xbuf[2][8];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int j0 = tid * 4;
  for (int i = tid; i < NSLOT; i += blockDim.x) {
    if (MODE == 14) {  // slot w holds codes 4w..4w+3, one byte each
      int pw = 0;
      for (int p = 0; p < 4; ++p) pw += ((4 * i + p) % 5) << (8 * p);
      codes[i] = pw;
    } else {
      codes[i] = i % 5;
    }
  }
  int x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = (j0 + k) * G_ + seed[blockIdx.x];
  __syncthreads();
  int par = 0;
  auto step = [&](int r, int qc) {
    int l0 = __shfl_up_sync(FULL, x[3], 1);
    if (MODE == 15) {  // the shift's carry across warps
      if (lane == 31) xbuf[par][wid] = x[3];
      __syncthreads();
      if (lane == 0 && wid > 0) l0 = xbuf[par][wid - 1];
      par ^= 1;
    }
    int nx[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k;
      const int col = j + (MODE == 16 ? r : 0);
      const int sc = col % 5 == qc ? 5 : -4;
      const int lft = k == 0 ? l0 : x[k - 1];
      nx[k] = max((j == 0 ? NEG_ : lft) + sc, x[k] + G_);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = nx[k];
  };
  int cnt = 0;
  if (MODE == 14) {  // one packed word per 4 rows
    for (int it = 0; it < (R + 3) / 4; ++it, ++cnt) {
      const int qword = codes[it];
      for (int p = 0; p < 4; ++p)
        if (it * 4 + p < R) step(it * 4 + p, (qword >> (8 * p)) & 0xFF);
    }
  } else {
    const int width = MODE == 15 ? ROW : 128;
    for (int r = 0; r < R; ++r) {
      step(r, codes[r]);
      cnt += MODE >= 15 ? width : 1;
    }
  }
  int* last = scratch + (size_t)blockIdx.x * per;  // the last row, for checks
#pragma unroll
  for (int k = 0; k < 4; ++k) last[j0 + k] = x[k];
  if (tid == 0) {
    out[blockIdx.x] = x[0] + x[1];
    steps[blockIdx.x] = cnt;
  }
}

// ---- modes 17, 18: banded-POA rows on an 8-row ring of 13 chunks --------

template <int MODE>
__global__ void __launch_bounds__(256)
probe_window(int R, const int* __restrict__ seed, int* __restrict__ out,
             int* __restrict__ steps, int* __restrict__ scratch, size_t per) {
  constexpr int W = MODE == 17 ? JC2 : CB;
  constexpr int NC = W * 128;
  constexpr int CH = (NC + 255) / 256;
  __shared__ int red[2][8];
  extern __shared__ int ring[];  // mode 18: [RING2 * JC2][128]
  const int tid = threadIdx.x;
  const int j0 = tid * CH;
  const int sd = seed[blockIdx.x];
  // the ring's seeding: word i holds (i / 128) % 97 + seed
  auto seeded = [&](int i) { return (i / 128) % 97 + sd; };
  if (MODE == 18)
    for (int i = tid; i < RING2 * JC2 * 128; i += 256) ring[i] = seeded(i);
  // the row before at the thread's columns and at column j0 - 1: mode 17's
  // window is the whole row, so rank 0 reads slot 0's seeding
  int prow[CH], pleft = j0 > 0 ? seeded(j0 - 1) : NEG_;
#pragma unroll
  for (int k = 0; k < CH; ++k) prow[k] = seeded(j0 + k);
  __syncthreads();
  int cells = 0, cb_prev = -1;
  // the window origin (in chunks) tracks the rank's backbone column:
  // r * JC2 / R - CB / 2, clamped; the quotient q and remainder rem of
  // r * JC2 / R are kept from rank to rank, so no division is on the chain
  int q = 0, rem = 0;
  for (int r = 0; r < R; ++r) {
    const int cb0 = min(max(q - CB / 2, 0), JC2 - W);
    for (rem += JC2; rem >= R; rem -= R) ++q;
    int P[CH + 1];
    if (MODE == 18 && cb0 != cb_prev) {
      // the window moved (or the first rank): its row before comes from
      // the ring, after every thread's write of the last rank
      __syncthreads();
      const int* pr = ring + (size_t)((r % RING2) * JC2 + cb0) * 128;
#pragma unroll
      for (int k = 0; k <= CH; ++k) {
        const int j = j0 - 1 + k;
        P[k] = (j >= 0 && j < NC) ? pr[j] : NEG_;
      }
    } else {
      P[0] = pleft;
#pragma unroll
      for (int k = 1; k <= CH; ++k) P[k] = j0 + k - 1 < NC ? prow[k - 1] : NEG_;
    }
    cb_prev = cb0;
    int x[CH], run = INT_MIN;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int j = j0 + k;
      if (j < NC) {
        const int diag = (j == 0 ? NEG_ : P[k]) + sc_of(j, 1);
        run = max(run, max(diag, P[k + 1] + G_) - j * G_);
      }
      x[k] = run;
    }
    const int ex = block_excl<false>(run, red[r & 1]);
    int* hr = ring + (size_t)(((r + 1) % RING2) * JC2 + cb0) * 128;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      prow[k] = max(x[k], ex) + (j0 + k) * G_;
      if (MODE == 18 && j0 + k < NC) hr[j0 + k] = prow[k];
    }
    pleft = j0 > 0 ? ex + (j0 - 1) * G_ : NEG_;
    cells += NC;
  }
  int* last = scratch + (size_t)blockIdx.x * per;  // ring slot R % RING2
  int o = prow[0] + prow[1];
  if (MODE == 17) {
#pragma unroll
    for (int k = 0; k < CH; ++k)
      if (j0 + k < NC) last[j0 + k] = prow[k];
  } else {
    __syncthreads();
    const int* hr = ring + (size_t)(R % RING2) * JC2 * 128;
    for (int i = tid; i < JC2 * 128; i += 256) last[i] = hr[i];
    o = hr[0] + hr[1];
  }
  if (tid == 0) {
    out[blockIdx.x] = o;
    steps[blockIdx.x] = cells;
  }
}

template <typename K>
cudaError_t launch(K kernel, int threads, size_t smem, int B,
                   cudaStream_t st, int R, const int* seed, int* out,
                   int* steps, int* scratch, size_t per) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, threads, smem, st>>>(R, seed, out, steps, scratch, per);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_band(int B, cudaStream_t st, int R, const int* seed,
                        int* out, int* steps, int* scratch, size_t per) {
  probe_band<MODE><<<B, MODE == 15 ? 256 : 32, 0, st>>>(R, seed, out, steps,
                                                         scratch, per);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch int32 words per program: its last row (or ring row), the only
// row it writes there.
long long rt_probe_scratch_words(int mode, int R) {
  (void)R;
  switch (mode) {
    case 8: return 2 * ROW;
    case 9: case 10: case 12: return (long long)LS_G * LS_W;
    case 13: case 14: case 16: return 128;
    case 17: case 18: return (long long)JC2 * 128;
    default: return ROW;
  }
}

// One block per program: seed i32[B] in, out and steps i32[B] out,
// scratch i32[B, rt_probe_scratch_words(mode, R)].
int rt_probe_launch(int mode, int R, const void* seed, void* out, void* steps,
                    void* scratch, int B, void* stream) {
  if (mode < 0 || mode > 18 || R < 1 || R > NSLOT - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* sd = (const int*)seed;
  int* o = (int*)out;
  int* s = (int*)steps;
  int* sc = (int*)scratch;
  const size_t per = (size_t)rt_probe_scratch_words(mode, R);
  const size_t gls = GSLOTS * 8 * 128 * sizeof(int);   // mode 10's rows
  const size_t rings = LS_G * RL * LS_W * sizeof(int);  // and its rings
  const size_t ring2 = RING2 * JC2 * 128 * sizeof(int);  // mode 18's ring
  auto go = [&](auto kernel, int threads, size_t smem) {
    return (int)launch(kernel, threads, smem, B, st, R, sd, o, s, sc, per);
  };
  switch (mode) {
    case 0: return go(probe_a<0>, 256, probe_a_smem(0));
    case 1: return go(probe_a<1>, 256, probe_a_smem(1));
    case 2: return go(probe_a<2>, 256, probe_a_smem(2));
    case 3: return go(probe_a<3>, 256, probe_a_smem(3));
    case 4: return go(probe_a<4>, 256, probe_a_smem(4));
    case 5: return go(probe_a<5>, 256, probe_a_smem(0));
    case 6: return go(probe_flat, 1024, 0);
    case 7: return go(probe_a<7>, 256, probe_a_smem(0));
    case 8: return go(probe_pair, 256, 0);
    case 9: return go(probe_ls<9>, 256, 0);
    case 10: return go(probe_ls<10>, 256, gls + rings);
    case 11: return go(probe_a<11>, 256, probe_a_smem(1));
    case 12: return go(probe_ls<12>, 256, 0);
    case 13: return (int)launch_band<13>(B, st, R, sd, o, s, sc, per);
    case 14: return (int)launch_band<14>(B, st, R, sd, o, s, sc, per);
    case 15: return (int)launch_band<15>(B, st, R, sd, o, s, sc, per);
    case 16: return (int)launch_band<16>(B, st, R, sd, o, s, sc, per);
    case 17: return go(probe_window<17>, 256, 0);
    default: return go(probe_window<18>, 256, ring2);
  }
}

}  // extern "C"
