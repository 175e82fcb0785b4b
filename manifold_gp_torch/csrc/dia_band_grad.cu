// DIA band cotangent for Hopper (sm_90a), kernel K5: the band's gradient
// in the backward of the DIA matvec (out = A(band) @ pv).
//
// Replaces no TPU kernel: the JAX package computes this cotangent in XLA
// (one roll, product and row sum per diagonal), and the port's plain
// version does the same in PyTorch (manifold_gp_torch/ops/dia.py,
// bar_band), which on the card costs 4 D launches a call and moves about
// 70 times the bytes the result needs. Wrapper: ops/dia.py (bar_band, which
// picks the template with band_grad_plan).
//
// What it computes, for every row i of the padded band space [0, Npd) and
// every lane j of the out_stride-lane band row:
//   bar[i, j] = sum_b g[i, b] * pv[i + off_j, b]      for j < D
//   bar[i, j] = 0                                      for D <= j
// in exact f32 FMAs (no TF32, no tensor cores). A read i + off_j outside
// [0, Npd) contributes 0 and is never made. Every lane of every row is
// written, so the output needs no zero fill. Out mode 0: f32; mode 1:
// bf16, each f32 sum rounded to nearest even (as a tensor's
// .to(torch.bfloat16)). No atomics: the sums' order is fixed, so two calls
// agree bit for bit.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM): bytes, by about 3x. The
// output cotangent and the operand are read once and the band row written
// once: 2*Npd*B*4 + Npd*out_stride*out_itemsize bytes against 2*Npd*D*B
// FLOPs. At the 262,144-point k = 16 curve (Npd = 263,168, D = 43, W = 21,
// f32 band): B = 128 moves 404 MB (0.121 ms) for 2.9 GFLOP (0.043 ms at
// 67 TFLOP/s); B = 1 moves 137 MB (0.041 ms), nearly all of it the band
// row's write. So, as in K4 (csrc/dia_spmv.cu), what costs besides the
// bytes is shared-memory traffic per FMA.
//
// Three templates, chosen by band_grad_plan in the wrapper from (D, W, B):
//
// * window (B >= 2, offsets filling [-W, W], so lane j is shift j and the
//   operand row of (i, j) is window row i + j): a block takes TR rows. It
//   stages, with 16-byte cp.async, the output cotangent g[TR, Bc] and the
//   operand window [TR + 8 NS - 1, Bc] (NS = ceil(D / 8); rows past
//   TR + 2W and outside [0, Npd) zero-filled) for a chunk of Bc <= 128
//   columns. The block's [TR, D] outputs split into tiles of 4 rows x 8
//   lanes; 8 threads share a tile, each taking the float4 column groups
//   q = t, t + 8, ... (a quarter-warp reads 128 contiguous bytes: no bank
//   conflict). A thread keeps g of its 4 rows for one group in registers
//   and slides down the 11 window rows the tile reads, each loaded once
//   and applied to every (row, lane) that reads it: 15 16-byte shared
//   loads feed 128 FMAs (2.1 FMAs a word). Then the 8 threads reduce their
//   32 partial sums by recursive halving (16 + 8 + 4 shuffles), after
//   which each holds 4 finished lanes of one row and writes them as one
//   16-byte (f32) or 8-byte (bf16) store. Lanes past D are dropped at the
//   store, lanes past 8 NS written as zeros. TR = 64 rows at the curves'
//   widths (90 KB at D = 43, B = 128: two blocks an SM, whose copies and
//   FMAs overlap); warps with no tile left in a pass sit it out.
//   Sum order, so that the result is no less accurate than the plain
//   version's (whose products round once each, then a near-pairwise row
//   sum): each 4-column dot product starts from 0 (products exact in the
//   FMAs), a thread adds its groups' dot products in turn, and the 8
//   threads' sums are added with their rounding errors carried (TwoSum,
//   a hi and a lo sum) and folded in once at the end. A thread's serial
//   sum of 16 columns into one accumulator, as K4 sums, read 1.1-1.2 x
//   the plain version's error against float64 on the card (0.20 ms at
//   B = 128, against 0.235 ms for this order). Above 128 columns the
//   block walks the chunks, reduces each, and adds the chunks' sums with
//   their errors carried too. Measured slower on the H100 and not kept
//   (PERF.md §6): a persistent block double-buffering its row runs
//   (0.27 ms), staging pass 0's rows first, g read through L1 at three
//   blocks an SM, 8 x 8 and 4 x 16 tiles, and runs of 32-48 rows.
// * general (B >= 2, any other layout: gapped offsets, W up to 512): the
//   same tiles and reduction; g is staged, the operand read from device
//   memory (a staged window would need TR + 2W rows), reads guarded.
// * row (B = 1): one warp a row, 4 lanes a thread, the product g[i] *
//   pv[i + off_j] (one rounding, as the plain sum of one term) read through
//   L1; the whole band row written with 16-byte (f32) or 8-byte stores.
//
// Outputs are written with evict-first stores (st.global.cs), as in K4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "ptx_helpers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 128;
constexpr int kChunk = 128;                // batch columns staged at a time
constexpr int kRows = 4;                   // rows of a tile
constexpr int kShifts = 8;                 // band lanes of a tile
constexpr int kLanes = 8;                  // threads sharing a tile's columns
constexpr int kSlots = kThreads / kLanes;  // tiles a block sums at once
constexpr int kAcc = kRows * kShifts;      // partial sums a thread holds
constexpr int kRowWarps = kThreads / 32;   // rows a row-template block takes at once
constexpr int kMaxSmem = 232448;           // an H100 block's dynamic shared-memory limit
constexpr int kMaxRowsPerBlock = 1024;

struct Offsets {
  int off[kMaxOffsets];
};

enum OutMode { kF32 = 0, kBF16 = 1 };
enum Kind { kRow = 0, kGeneral = 1, kWindow = 2 };

constexpr int kKeep = kAcc / kLanes;       // finished sums a thread holds after the reduction

// a . b for one float4 column group, started from 0.
__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// s + e == a + b exactly, s the rounded sum (Knuth's TwoSum).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bp = s - a;
  e = (a - (s - bp)) + (b - bp);
}

// Four consecutive band lanes of one row at element `at`, in the band's
// type: one 16-byte (f32) or 8-byte (bf16) evict-first store.
template <int MODE>
__device__ __forceinline__ void store4(void* out, size_t at, float a, float b, float c, float d) {
  if (MODE == kF32) {
    __stcs(reinterpret_cast<float4*>(static_cast<float*>(out) + at), make_float4(a, b, c, d));
  } else {
    __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at),
           make_uint2(pack_bf16x2(a, b), pack_bf16x2(c, d)));
  }
}

// Lanes [from, out_stride) of rows [r0, r0 + nrows) below npd set to zero.
template <int MODE>
__device__ __forceinline__ void zero_lanes(void* out, int r0, int nrows, int npd, int from,
                                           int out_stride) {
  const int pieces = (out_stride - from) / 4;
  for (int e = threadIdx.x; e < nrows * pieces; e += kThreads) {
    const int rr = e / pieces;
    if (r0 + rr >= npd) break;
    store4<MODE>(out, (size_t)(r0 + rr) * out_stride + from + 4 * (e - rr * pieces),
                 0.f, 0.f, 0.f, 0.f);
  }
}

// Stage rows [first, first + nrows) x columns [c0, c0 + bc) of the f32
// matrix src [npd, batch] into dst [nrows][bp] (bp: bc rounded up to 4).
// Rows past `valid` (counted from first) or outside [0, npd), and columns
// past bc, are zero-filled and never read.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int first, int nrows,
                                           int valid, int npd, int batch, int c0, int bc, int bp,
                                           bool vec) {
  if (vec) {
    const int groups = bp >> 2;
    for (int e = threadIdx.x; e < nrows * groups; e += kThreads) {
      const int rr = e / groups;
      const int q = e - rr * groups;
      const int row = first + rr;
      const bool ok = rr < valid && row >= 0 && row < npd;
      cp_async16(dst + (size_t)rr * bp + 4 * q, ok ? src + (size_t)row * batch + c0 + 4 * q : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * bp; e += kThreads) {
      const int rr = e / bp;
      const int c = e - rr * bp;
      const int row = first + rr;
      const bool ok = rr < valid && row >= 0 && row < npd && c < bc;
      cp_async4(dst + e, ok ? src + (size_t)row * batch + c0 + c : src, ok ? 4 : 0);
    }
  }
}

// One step of the tile's reduction: threads whose lanes differ in MASK
// swap halves of their first 2 HALF (hi, lo) sums and add them, hi by
// TwoSum, so each keeps HALF.
// (FIRST: the lo sums are still zero and are not exchanged.)
template <int HALF, int MASK, bool FIRST>
__device__ __forceinline__ void halve(float (&hi)[kAcc], float (&lo)[kAcc], int sub) {
  const bool upper = (sub & MASK) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send_hi = upper ? hi[i] : hi[i + HALF];
    const float keep_hi = upper ? hi[i + HALF] : hi[i];
    float e;
    two_sum(keep_hi, __shfl_xor_sync(0xffffffffu, send_hi, MASK), hi[i], e);
    if (FIRST) {
      lo[i] = e;
    } else {
      const float send_lo = upper ? lo[i] : lo[i + HALF];
      const float keep_lo = upper ? lo[i + HALF] : lo[i];
      lo[i] = (keep_lo + __shfl_xor_sync(0xffffffffu, send_lo, MASK)) + e;
    }
  }
}

// Sum the tile's partial sums (index r * kShifts + s) over its kLanes
// threads: thread `sub` ends with sums 4 sub .. 4 sub + 3 in hi[0..3] +
// lo[0..3], i.e. row sub / 2, lanes 4 (sub % 2) .. + 3 of the tile.
__device__ __forceinline__ void reduce_tile(float (&hi)[kAcc], float (&lo)[kAcc], int sub) {
  static_assert(kAcc == 32 && kLanes == 8 && kKeep == 4, "three halvings leave 4 sums a thread");
  halve<16, 4, true>(hi, lo, sub);
  halve<8, 2, false>(hi, lo, sub);
  halve<4, 1, false>(hi, lo, sub);
}

// Add a chunk's reduced sums (hi, lo) into the running (sum, err).
__device__ __forceinline__ void add_chunk(float (&sum)[kKeep], float (&err)[kKeep],
                                          const float (&hi)[kAcc], const float (&lo)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kKeep; ++i) {
    float e;
    two_sum(sum[i], hi[i], sum[i], e);
    err[i] += e + lo[i];
  }
}

// Write a tile's 4 finished lanes, sum + err (lanes past d as zeros).
template <int MODE>
__device__ __forceinline__ void store_tile(void* out, const float (&sum)[kKeep],
                                           const float (&err)[kKeep], int row, int j, int d,
                                           int npd, int out_stride) {
  if (row >= npd) return;
  float v[kKeep];
#pragma unroll
  for (int i = 0; i < kKeep; ++i) v[i] = j + i < d ? sum[i] + err[i] : 0.f;
  store4<MODE>(out, (size_t)row * out_stride + j, v[0], v[1], v[2], v[3]);
}

// window template. Shared memory (dynamic): the operand window
// [tr + 8 ns - 1][bp_max] f32, then g [tr][bp_max] f32. Requires
// d == 2w + 1 and offsets[j] == j - w (checked by the C entry).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
band_grad_window_kernel(const float* __restrict__ g, const float* __restrict__ pv,
                        void* __restrict__ out, int d, int w, int npd, int batch, int out_stride,
                        int tr, int bp_max, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = (d + kShifts - 1) / kShifts;
  const int win_rows = tr + kShifts * ns - 1;  // >= tr + 2w: the last tile's reads
  float* win = reinterpret_cast<float*>(smem);
  float* gs = win + (size_t)win_rows * bp_max;
  const int r0 = blockIdx.x * tr;
  const int sub = threadIdx.x % kLanes;
  const int slot = threadIdx.x / kLanes;
  const int ntiles = (tr / kRows) * ns;
  const int nchunks = (batch + kChunk - 1) / kChunk;
  zero_lanes<MODE>(out, r0, tr, npd, kShifts * ns, out_stride);

  for (int t0 = 0; t0 < ntiles; t0 += kSlots) {
    const int t = min(t0 + slot, ntiles - 1);  // a spare slot redoes the last tile, unstored
    const bool busy = t0 + (slot & ~(32 / kLanes - 1)) < ntiles;  // the warp has a tile
    const int rb = (t / ns) * kRows;
    const int s0 = (t % ns) * kShifts;
    float sum[kKeep], err[kKeep];
#pragma unroll
    for (int i = 0; i < kKeep; ++i) sum[i] = err[i] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * kChunk;
      const int bc = min(kChunk, batch - c0);
      const int groups = (bc + 3) >> 2;
      if (t0 == 0 || nchunks > 1) {  // one chunk is staged once for every pass
        __syncthreads();             // the previous chunk's readers are done
        stage_rows(win, pv, r0 - w, win_rows, tr + 2 * w, npd, batch, c0, bc, 4 * groups, vec);
        stage_rows(gs, g, r0, tr, tr, npd, batch, c0, bc, 4 * groups, vec);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!busy) continue;
      const float4* x_at = reinterpret_cast<const float4*>(win) + (size_t)(rb + s0) * groups;
      const float4* g_at = reinterpret_cast<const float4*>(gs) + (size_t)rb * groups;
      float hi[kAcc], lo[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) hi[i] = 0.f;
      for (int q = sub; q < groups; q += kLanes) {
        float4 gr[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) gr[r] = g_at[(size_t)r * groups + q];
#pragma unroll
        for (int u = 0; u < kRows + kShifts - 1; ++u) {  // window rows the tile reads
          const float4 x = x_at[(size_t)u * groups + q];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int s = u - r;
            if (s >= 0 && s < kShifts) hi[r * kShifts + s] += dot4(gr[r], x);
          }
        }
      }
      reduce_tile(hi, lo, sub);
      add_chunk(sum, err, hi, lo);
    }
    if (busy && t0 + slot < ntiles)
      store_tile<MODE>(out, sum, err, r0 + rb + sub / 2, s0 + 4 * (sub % 2), d, npd, out_stride);
  }
}

// general template. Shared memory (dynamic): g [tr][bp_max] f32; the
// offsets in static shared memory; the operand read from device memory.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
band_grad_general_kernel(const float* __restrict__ g, const float* __restrict__ pv,
                         void* __restrict__ out, const Offsets offs, int d, int npd, int batch,
                         int out_stride, int tr, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_off[kMaxOffsets];
  for (int j = threadIdx.x; j < kMaxOffsets; j += kThreads) s_off[j] = j < d ? offs.off[j] : 0;
  const int ns = (d + kShifts - 1) / kShifts;
  float* gs = reinterpret_cast<float*>(smem);
  const int r0 = blockIdx.x * tr;
  const int sub = threadIdx.x % kLanes;
  const int slot = threadIdx.x / kLanes;
  const int ntiles = (tr / kRows) * ns;
  const int nchunks = (batch + kChunk - 1) / kChunk;
  zero_lanes<MODE>(out, r0, tr, npd, kShifts * ns, out_stride);

  for (int t0 = 0; t0 < ntiles; t0 += kSlots) {
    const int t = min(t0 + slot, ntiles - 1);
    const bool busy = t0 + (slot & ~(32 / kLanes - 1)) < ntiles;
    const int rb = (t / ns) * kRows;
    const int s0 = (t % ns) * kShifts;
    float sum[kKeep], err[kKeep];
#pragma unroll
    for (int i = 0; i < kKeep; ++i) sum[i] = err[i] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * kChunk;
      const int bc = min(kChunk, batch - c0);
      const int groups = (bc + 3) >> 2;
      if (t0 == 0 || nchunks > 1) {
        __syncthreads();
        stage_rows(gs, g, r0, tr, tr, npd, batch, c0, bc, 4 * groups, vec);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!busy) continue;
      const float4* g_at = reinterpret_cast<const float4*>(gs) + (size_t)rb * groups;
      float hi[kAcc], lo[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) hi[i] = 0.f;
      for (int q = sub; q < groups; q += kLanes) {
        const int col = c0 + 4 * q;
        const int ncol = min(4, bc - 4 * q);
        float4 gr[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) gr[r] = g_at[(size_t)r * groups + q];
#pragma unroll
        for (int s = 0; s < kShifts; ++s) {
          const int off = s_off[min(s0 + s, d - 1)];  // lanes past d: dropped at the store
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int src = r0 + rb + r + off;
            if (src < 0 || src >= npd) continue;
            const float* p = pv + (size_t)src * batch + col;
            float4 x;
            if (vec) {
              x = __ldg(reinterpret_cast<const float4*>(p));
            } else {
              x.x = __ldg(p);
              x.y = ncol > 1 ? __ldg(p + 1) : 0.f;
              x.z = ncol > 2 ? __ldg(p + 2) : 0.f;
              x.w = ncol > 3 ? __ldg(p + 3) : 0.f;
            }
            hi[r * kShifts + s] += dot4(gr[r], x);
          }
        }
      }
      reduce_tile(hi, lo, sub);
      add_chunk(sum, err, hi, lo);
    }
    if (busy && t0 + slot < ntiles)
      store_tile<MODE>(out, sum, err, r0 + rb + sub / 2, s0 + 4 * (sub % 2), d, npd, out_stride);
  }
}

// row template (B = 1): one warp a row, lanes 4 t .. 4 t + 3 a thread.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
band_grad_row_kernel(const float* __restrict__ g, const float* __restrict__ pv,
                     void* __restrict__ out, const Offsets offs, int d, int npd,
                     int out_stride) {
  __shared__ int s_off[kMaxOffsets];
  for (int j = threadIdx.x; j < kMaxOffsets; j += kThreads) s_off[j] = j < d ? offs.off[j] : 0;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int row = blockIdx.x * kRowWarps + threadIdx.x / 32; row < npd;
       row += gridDim.x * kRowWarps) {
    const float gi = __ldg(g + row);
    for (int p = lane; p < out_stride / 4; p += 32) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * p + k;
        v[k] = 0.f;
        if (j < d) {
          const int src = row + s_off[j];
          if (src >= 0 && src < npd) v[k] = gi * __ldg(pv + src);
        }
      }
      store4<MODE>(out, (size_t)row * out_stride + 4 * p, v[0], v[1], v[2], v[3]);
    }
  }
}

// Raise a kernel's dynamic shared-memory limit once per device, to what
// its static shared memory leaves of a block's limit.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned& done_mask) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done_mask & bit)) return cudaSuccess;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) done_mask |= bit;
  return err;
}

struct Launch {
  const float* g;
  const float* pv;
  void* out;
  Offsets offs;
  int d, w, npd, batch, out_stride, tr, vec;
  cudaStream_t st;
};

// The templates' shared-memory sums below are also made by
// ops/dia.py::band_grad_smem, which band_grad_plan sizes row runs with:
// change both.
template <int MODE>
int launch_window(const Launch& a) {
  static unsigned done = 0;
  const int bp_max = 4 * ((std::min(a.batch, kChunk) + 3) / 4);
  const int ns = (a.d + kShifts - 1) / kShifts;
  const size_t smem = (size_t)(2 * a.tr + kShifts * ns - 1) * bp_max * sizeof(float);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(band_grad_window_kernel<MODE>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  band_grad_window_kernel<MODE><<<(a.npd + a.tr - 1) / a.tr, kThreads, smem, a.st>>>(
      a.g, a.pv, a.out, a.d, a.w, a.npd, a.batch, a.out_stride, a.tr, bp_max, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_general(const Launch& a) {
  static unsigned done = 0;
  const int bp_max = 4 * ((std::min(a.batch, kChunk) + 3) / 4);
  const size_t smem = (size_t)a.tr * bp_max * sizeof(float);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(band_grad_general_kernel<MODE>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  band_grad_general_kernel<MODE><<<(a.npd + a.tr - 1) / a.tr, kThreads, smem, a.st>>>(
      a.g, a.pv, a.out, a.offs, a.d, a.npd, a.batch, a.out_stride, a.tr, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_row(const Launch& a) {
  const int blocks = std::min((a.npd + kRowWarps - 1) / kRowWarps, 4096);
  band_grad_row_kernel<MODE><<<blocks, kThreads, 0, a.st>>>(a.g, a.pv, a.out, a.offs, a.d,
                                                            a.npd, a.out_stride);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch(const Launch& a, int kind) {
  switch (kind) {
    case kRow:
      return launch_row<MODE>(a);
    case kWindow:
      return launch_window<MODE>(a);
    case kGeneral:
      return launch_general<MODE>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (loaded with ctypes). g, pv: f32 [npd, batch]; out:
// f32 (mode 0) or bf16 (mode 1) [npd, out_stride], 16-byte aligned, every
// lane written; offsets: host array of d ints, each |off| <= w <= 512,
// copied into the kernel's parameters, with round_up(d, 8) <= out_stride.
// The plan (ops/dia.py::band_grad_plan): kind 0 = row (batch 1,
// rows_per_block 8: one warp a row), 1 = general, 2 = window (offsets
// exactly -w .. w); rows_per_block a multiple of 4 otherwise. All device
// arrays contiguous. Launches on `stream` and returns a cudaError_t
// (0 = launched); arguments out of range launch nothing and return
// cudaErrorInvalidValue.
extern "C" int dia_band_grad(const float* g, const float* pv, void* out, const int* offsets,
                             int d, int w, int npd, int batch, int out_stride, int mode, int kind,
                             int rows_per_block, void* stream) {
  if (npd <= 0 || batch <= 0 || d <= 0 || d > kMaxOffsets || w < 0 || w > 512 ||
      out_stride % 8 != 0 || (d + kShifts - 1) / kShifts * kShifts > out_stride ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kind == kRow) != (batch == 1) ||
      (kind == kRow ? rows_per_block != kRowWarps
                    : rows_per_block < kRows || rows_per_block > kMaxRowsPerBlock ||
                          rows_per_block % kRows != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a;
  for (int j = 0; j < kMaxOffsets; ++j) a.offs.off[j] = 0;
  for (int j = 0; j < d; ++j) {
    if (offsets[j] < -w || offsets[j] > w) return static_cast<int>(cudaErrorInvalidValue);
    if (kind == kWindow && offsets[j] != j - w) return static_cast<int>(cudaErrorInvalidValue);
    a.offs.off[j] = offsets[j];
  }
  if (kind == kWindow && d != 2 * w + 1) return static_cast<int>(cudaErrorInvalidValue);
  a.g = g;
  a.pv = pv;
  a.out = out;
  a.d = d;
  a.w = w;
  a.npd = npd;
  a.batch = batch;
  a.out_stride = out_stride;
  a.tr = rows_per_block;
  a.vec = batch % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(pv) % 16 == 0;
  a.st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      return dispatch<kF32>(a, kind);
    case kBF16:
      return dispatch<kBF16>(a, kind);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
