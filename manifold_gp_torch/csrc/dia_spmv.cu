// DIA band SpMV for Hopper (sm_90a): out = A @ pv in DIA (RCM band) space.
//
// Replaces the Pallas TPU kernel K4 of manifold_gp_tpu/ops/dia.py
// (_dia_kernel, called by dia_matvec_pallas); wrapper:
// manifold_gp_torch/ops/dia.py (dia_matvec_call, which picks the template
// with dia_plan).
//
// What it computes, for every row i of the padded band space [0, Npd):
//   out[i, b] = sum_d band[i, d] * pv[i + off_d, b]
// in exact f32 FMAs (no TF32, no tensor cores), over the D offsets in the
// order given. A read i + off_d outside [0, Npd) contributes 0 and is never
// made (halo rows carry zero bands, but a 0 * NaN from an unguarded read
// would still poison the sum). The band is stored [Npd, band_stride] (128
// lanes, a TPU DMA layout); only the first D lanes are read. Band mode 0:
// f32; mode 1: bf16, widened to f32 before the product, as the TPU kernel
// multiplies a bf16 band by an f32 window.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM): bytes. Each band lane used
// is read once and the operand and output once each:
// Npd*D*band_itemsize + 2*Npd*B*4 bytes against 2*Npd*D*B FLOPs. At the
// 262,144-point k = 8 curve (Npd = 261,120, D = 21, W = 10, f32 band):
// B = 128 moves 289 MB (0.086 ms), B = 100 0.069 ms, B = 1 0.007 ms; the
// FMAs alone take 0.021 ms at 67 TFLOP/s. So the work per byte is small,
// and what costs is shared-memory traffic: the simple first version (one
// band load and one window load per FMA) needed about 2 shared wavefronts
// per warp-FMA, twice the byte bound.
//
// Three templates, chosen by dia_plan in the wrapper from (D, W, B):
//
// * window (B >= 2, offsets filling [-W, W], so D = 2W + 1 and lane j is
//   shift j, as on the k = 8, 16 and 24 curves): a block covers up to 128
//   batch columns (above 128, blockIdx.y walks 128-column chunks), so the
//   band's D lanes are read from HBM once per row at B <= 128. Batch
//   columns map to float4 groups (25 at B = 100): no empty lanes at a
//   ragged B. A thread owns R consecutive rows x one float4 group and
//   slides down the operand window: each window row u is loaded once (one
//   16-byte shared load) and applied to every owned row r that reads it
//   (shift s = u - r), acc[r] += band[r][s] * x, r unrolled. A warp's
//   threads share their rows, so the band load is a broadcast: about
//   (R + 4) / (4R) = 0.375 shared wavefronts per warp-FMA at R = 8, against
//   2 before, which leaves the bytes in charge.
//   Staging and overlap: a block takes one run of TR rows. It copies the
//   operand window [TR + 2W, Bc] (one contiguous run of the row-major
//   operand; 16-byte cp.async where B % 4 == 0, else 4-byte copies with
//   the padding columns zero-filled; rows outside [0, Npd) zero-filled,
//   never read) and the band lanes [TR, D] (16-byte cp.async) into shared
//   memory, waits, and sums. Overlap comes from occupancy: dia_plan keeps a
//   block's shared memory small enough (TR = 64 rows at B = 128, 49 KB)
//   that four blocks share an SM, so one block's copies run under the
//   others' FMAs. A persistent block walking its row runs through a
//   two-stage ring (the 2W halo copied once per block) was built and
//   measured slower on the H100 (PERF.md §6), and was not kept.
// * general (B >= 2, any other layout: gapped offsets, W up to 512): the
//   band lanes are staged with 16-byte cp.async, the operand is read
//   straight from device memory (a staged window would need 2W + TR rows,
//   0.5 MB at W = 512 and B = 128), each thread loops over the D diagonals
//   with R rows x one float4 group in registers, reads guarded.
// * row (B = 1): one row a thread, the band row read with 16-byte loads,
//   the operand through the L1 cache; no shared memory.
//
// Outputs are written with evict-first stores (st.global.cs) so that they
// do not push the next window out of L2. Each template's dynamic
// shared-memory limit is raised once per device, not on every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "ptx_helpers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 128;
constexpr int kChunk = 128;        // batch columns a block covers
constexpr int kRows = 8;           // rows a thread sums (window, general)
constexpr int kMaxSmem = 232448;   // an H100 block's dynamic shared-memory limit
constexpr int kMaxRowsPerBlock = 8192;

struct Offsets {
  int off[kMaxOffsets];
};

enum BandMode { kF32 = 0, kBF16 = 1 };
enum Kind { kRow = 0, kGeneral = 1, kWindow = 2 };

template <int MODE>
struct BandType {
  static constexpr int kBytes = MODE == kF32 ? 4 : 2;
  static constexpr int kLanes16 = 16 / kBytes;  // band lanes per 16-byte piece
};

template <int MODE>
__device__ __forceinline__ float band_at(const unsigned char* tile, int i) {
  if (MODE == kF32) return reinterpret_cast<const float*>(tile)[i];
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(tile)[i]);
}

__device__ __forceinline__ void fma4(float4& acc, float b, const float4& x) {
  acc.x = fmaf(b, x.x, acc.x);
  acc.y = fmaf(b, x.y, acc.y);
  acc.z = fmaf(b, x.z, acc.z);
  acc.w = fmaf(b, x.w, acc.w);
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Band lanes padded to whole 16-byte pieces.
template <int MODE>
__host__ __device__ __forceinline__ int band_pitch(int d) {
  constexpr int L = BandType<MODE>::kLanes16;
  return (d + L - 1) / L * L;
}

// Stage band lanes [0, dp) of rows [r0, r0 + tr) into `tile` ([tr][dp] in
// the band's own type), 16 bytes a copy; rows past npd are zero-filled.
template <int MODE>
__device__ __forceinline__ void stage_band(unsigned char* tile, const void* band, int r0,
                                           int tr, int dp, int npd, int band_stride) {
  constexpr int L = BandType<MODE>::kLanes16;
  constexpr int kBytes = BandType<MODE>::kBytes;
  const int pieces = dp / L;
  const unsigned char* src0 = static_cast<const unsigned char*>(band);
  for (int e = threadIdx.x; e < tr * pieces; e += kThreads) {
    const int rr = e / pieces;
    const int p = e - rr * pieces;
    const int row = r0 + rr;
    const bool ok = row < npd;
    const unsigned char* src = src0 + ((size_t)(ok ? row : 0) * band_stride + p * L) * kBytes;
    cp_async16(tile + ((size_t)rr * dp + p * L) * kBytes, src, ok ? 16 : 0);
  }
}

// Write R rows x one float4 column group (columns c0 + 4g ..) with
// evict-first stores; a ragged group writes only its valid columns.
template <int R>
__device__ __forceinline__ void store_rows(float* out, const float4 (&acc)[R], int row0,
                                           int npd, int batch, int col, int ncol, bool vec) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= npd) break;
    float* dst = out + (size_t)row * batch + col;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(dst), acc[r]);
    } else {
      for (int c = 0; c < ncol; ++c) __stcs(dst + c, lane(acc[r], c));
    }
  }
}

// window template. Shared memory (dynamic): window [tr + 2w][4G] f32, then
// band lanes [tr][dp] in the band's type. Requires d == 2w + 1 and
// offsets[j] == j - w (checked by the C entry).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
dia_window_kernel(const void* __restrict__ band, const float* __restrict__ pv,
                  float* __restrict__ out, int d, int w, int npd, int batch, int band_stride,
                  int tr, int bp_max, int vec) {
  constexpr int R = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.y * kChunk;
  const int bc = min(kChunk, batch - c0);
  const int groups = (bc + 3) >> 2;
  const int bp = 4 * groups;
  const int dp = band_pitch<MODE>(d);
  const int win_rows = tr + 2 * w;
  float* win = reinterpret_cast<float*>(smem);
  unsigned char* bnd = smem + (size_t)win_rows * bp_max * sizeof(float);
  const int r0 = blockIdx.x * tr;

  // operand window: rows [r0 - w, r0 + tr + w), columns [c0, c0 + bc)
  if (vec) {
    for (int e = threadIdx.x; e < win_rows * groups; e += kThreads) {
      const int wr = e / groups;
      const int q = e - wr * groups;
      const int row = r0 - w + wr;
      const bool ok = row >= 0 && row < npd;
      const float* src = ok ? pv + (size_t)row * batch + c0 + 4 * q : pv;
      cp_async16(win + (size_t)wr * bp + 4 * q, src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < win_rows * bp; e += kThreads) {
      const int wr = e / bp;
      const int c = e - wr * bp;
      const int row = r0 - w + wr;
      const bool ok = row >= 0 && row < npd && c < bc;
      cp_async4(win + e, ok ? pv + (size_t)row * batch + c0 + c : pv, ok ? 4 : 0);
    }
  }
  stage_band<MODE>(bnd, band, r0, tr, dp, npd, band_stride);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float4* win4 = reinterpret_cast<const float4*>(win);
  const int items = (tr / R) * groups;
  const int span = R + 2 * w;  // window rows one row group reads
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int rg = it / groups;
    const int g = it - rg * groups;
    const int rb = rg * R;
    const float4* x_at = win4 + (size_t)rb * groups + g;
    const int b_at = rb * dp;
    float4 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int u = 0; u < span; ++u) {
      const float4 x = x_at[(size_t)u * groups];
      if (u >= R - 1 && u < d) {  // every owned row reads window row u
#pragma unroll
        for (int r = 0; r < R; ++r) fma4(acc[r], band_at<MODE>(bnd, b_at + r * dp + u - r), x);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int s = u - r;
          if (s >= 0 && s < d) fma4(acc[r], band_at<MODE>(bnd, b_at + r * dp + s), x);
        }
      }
    }
    store_rows<R>(out, acc, r0 + rb, npd, batch, c0 + 4 * g, min(4, bc - 4 * g), vec);
  }
}

// general template. Shared memory (dynamic): band lanes [tr][dp] in the
// band's type; the operand is read from device memory.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
dia_general_kernel(const void* __restrict__ band, const float* __restrict__ pv,
                   float* __restrict__ out, const Offsets offs, int d, int npd, int batch,
                   int band_stride, int tr, int vec) {
  constexpr int R = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.y * kChunk;
  const int bc = min(kChunk, batch - c0);
  const int groups = (bc + 3) >> 2;
  const int dp = band_pitch<MODE>(d);
  const int r0 = blockIdx.x * tr;
  stage_band<MODE>(smem, band, r0, tr, dp, npd, band_stride);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int items = (tr / R) * groups;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int rg = it / groups;
    const int g = it - rg * groups;
    const int rb = rg * R;
    const int col = c0 + 4 * g;
    const int ncol = min(4, bc - 4 * g);
    float4 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < d; ++j) {
      const int off = offs.off[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
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
        fma4(acc[r], band_at<MODE>(smem, (rb + r) * dp + j), x);
      }
    }
    store_rows<R>(out, acc, r0 + rb, npd, batch, col, ncol, vec);
  }
}

// row template (B = 1): one row a thread, its band lanes read 16 bytes at a
// time (four pieces in flight), the operand through L1.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
dia_row_kernel(const void* __restrict__ band, const float* __restrict__ pv,
               float* __restrict__ out, const Offsets offs, int d, int npd, int band_stride) {
  constexpr int L = BandType<MODE>::kLanes16;
  constexpr int kAhead = 4;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= npd) return;
  const uint4* brow = reinterpret_cast<const uint4*>(
      static_cast<const unsigned char*>(band) + (size_t)row * band_stride * BandType<MODE>::kBytes);
  float acc = 0.f;
  for (int p0 = 0; p0 * L < d; p0 += kAhead) {
    uint4 piece[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      piece[q] = (p0 + q) * L < d ? __ldg(brow + p0 + q) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const uint32_t words[4] = {piece[q].x, piece[q].y, piece[q].z, piece[q].w};
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int j = (p0 + q) * L + l;
        if (j >= d) break;
        // bf16 -> f32 is exact: the 16 bits become the high half
        const float b = MODE == kF32 ? __uint_as_float(words[l])
                        : __uint_as_float(l % 2 ? words[l / 2] & 0xffff0000u : words[l / 2] << 16);
        const int src = row + offs.off[j];
        if (src >= 0 && src < npd) acc = fmaf(b, __ldg(pv + src), acc);
      }
    }
  }
  __stcs(out + row, acc);
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned& done_mask) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done_mask & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done_mask |= bit;
  return err;
}

struct Launch {
  const void* band;
  const float* pv;
  float* out;
  Offsets offs;
  int d, w, npd, batch, band_stride, tr, vec;
  cudaStream_t st;
};

// The two templates' shared-memory sums below are also made by
// ops/dia.py::block_smem, which dia_plan sizes row runs with: change both.
template <int MODE>
int launch_window(const Launch& a) {
  static unsigned done = 0;
  const int bp_max = 4 * ((std::min(a.batch, kChunk) + 3) / 4);
  const size_t smem = (size_t)(a.tr + 2 * a.w) * bp_max * sizeof(float) +
                      (size_t)a.tr * band_pitch<MODE>(a.d) * BandType<MODE>::kBytes;
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(dia_window_kernel<MODE>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.npd + a.tr - 1) / a.tr, (a.batch + kChunk - 1) / kChunk);
  dia_window_kernel<MODE><<<grid, kThreads, smem, a.st>>>(
      a.band, a.pv, a.out, a.d, a.w, a.npd, a.batch, a.band_stride, a.tr, bp_max, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_general(const Launch& a) {
  static unsigned done = 0;
  const size_t smem = (size_t)a.tr * band_pitch<MODE>(a.d) * BandType<MODE>::kBytes;
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(dia_general_kernel<MODE>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.npd + a.tr - 1) / a.tr, (a.batch + kChunk - 1) / kChunk);
  dia_general_kernel<MODE><<<grid, kThreads, smem, a.st>>>(
      a.band, a.pv, a.out, a.offs, a.d, a.npd, a.batch, a.band_stride, a.tr, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_row(const Launch& a) {
  dia_row_kernel<MODE><<<(a.npd + kThreads - 1) / kThreads, kThreads, 0, a.st>>>(
      a.band, a.pv, a.out, a.offs, a.d, a.npd, a.band_stride);
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

// Plain C entry point (loaded with ctypes). band: f32 (mode 0) or bf16
// (mode 1) [npd, band_stride], 16-byte aligned; pv, out: f32 [npd, batch];
// offsets: host array of d ints, each |off| <= w <= 512, copied into the
// kernel's parameters. The plan (ops/dia.py::dia_plan): kind 0 = row
// (batch 1, rows_per_thread 1), 1 = general, 2 = window (offsets exactly
// -w .. w); rows_per_thread 1 for the row kernel, kRows otherwise;
// rows_per_block a multiple of it. All
// device arrays contiguous. Launches on `stream` and returns a cudaError_t
// (0 = launched); arguments out of range launch nothing and return
// cudaErrorInvalidValue.
extern "C" int dia_spmv(const void* band, const float* pv, float* out, const int* offsets,
                        int d, int w, int npd, int batch, int band_stride, int mode, int kind,
                        int rows_per_thread, int rows_per_block, void* stream) {
  if (npd <= 0 || batch <= 0 || d <= 0 || d > kMaxOffsets || d > band_stride || w < 0 ||
      w > 512 || band_stride % 8 != 0 || reinterpret_cast<uintptr_t>(band) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_per_thread != (kind == kRow ? 1 : kRows) || rows_per_block < rows_per_thread ||
      rows_per_block > kMaxRowsPerBlock || rows_per_block % rows_per_thread != 0 ||
      (kind == kRow) != (batch == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a;
  for (int j = 0; j < kMaxOffsets; ++j) a.offs.off[j] = 0;
  for (int j = 0; j < d; ++j) {
    if (offsets[j] < -w || offsets[j] > w) return static_cast<int>(cudaErrorInvalidValue);
    if (kind == kWindow && offsets[j] != j - w) return static_cast<int>(cudaErrorInvalidValue);
    a.offs.off[j] = offsets[j];
  }
  if (kind == kWindow && d != 2 * w + 1) return static_cast<int>(cudaErrorInvalidValue);
  a.band = band;
  a.pv = pv;
  a.out = out;
  a.d = d;
  a.w = w;
  a.npd = npd;
  a.batch = batch;
  a.band_stride = band_stride;
  a.tr = rows_per_block;
  a.vec = batch % 4 == 0 && reinterpret_cast<uintptr_t>(pv) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
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
