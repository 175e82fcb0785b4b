// DIA band SpMV for Hopper (sm_90a): out = A @ pv in DIA (RCM band) space.
//
// Replaces the Pallas TPU kernel K4 of manifold_gp_tpu/ops/dia.py
// (_dia_kernel, called by dia_matvec_pallas); wrapper:
// manifold_gp_torch/ops/dia.py (dia_matvec_call).
//
// What it computes, for every row i of the padded band space [0, Npd):
//   out[i, b] = sum_d band[i, d] * pv[i + off_d, b]
// in exact f32 FMAs, over the D offsets in the order given. A read
// i + off_d outside [0, Npd) contributes 0 (halo rows carry zero bands, but
// a 0 * NaN from an unguarded read would still poison the sum). The band is
// stored [Npd, band_stride] (128 lanes, a TPU DMA layout); only the first D
// lanes are read. Band mode 0: f32; mode 1: bf16, widened to f32 before the
// product, as the TPU kernel multiplies a bf16 band by an f32 window.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM; nvidia-smi names the part
// "NVIDIA H100 80GB HBM3"): bytes. Each band lane used is read once and
// the operand and output once each: Npd*D*band_itemsize + 2*Npd*B*4 bytes,
// against 2*Npd*D*B FLOPs. At the 262,144-point curve (Npd = 261,120,
// D ~ 19, f32 band): B = 128 moves ~287 MB (~0.086 ms), B = 100 ~0.068 ms,
// B = 1 ~22 MB (~0.007 ms, where the launch itself rules). At 2*D FLOPs per
// 8 operand bytes the FMAs are far from the 67 TFLOP/s f32 peak.
//
// What this simple design does about it: the TPU kernel's sequential grid
// with a double-buffered window DMA does not carry over (blocks run in
// parallel and in no order). Each thread block owns a tile of TR rows and
// TB batch columns; it stages the operand window [TR + 2W, TB] (guarded
// rows and ragged batch columns read as 0) and the band's D used lanes
// for its rows (widened to f32) in shared memory, then each thread sums
// its outputs over the D diagonals. Rows, window and band lanes are loaded
// with neighbouring threads on neighbouring addresses. The halo reads
// (2W rows per tile) come mostly from L2. TB adapts to the batch (1 .. 32)
// so B = 1 does not stage 31 empty columns. The D <= 128 offsets travel by
// value in the kernel's parameters. Not done yet: register blocking over
// rows (each output costs 2 shared-memory loads per diagonal), cp.async/TMA
// staging overlapped with the FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 128;

struct Offsets {
  int off[kMaxOffsets];
};

enum BandMode { kF32 = 0, kBF16 = 1 };

template <int MODE>
__device__ __forceinline__ float load_band(const void* band, size_t i) {
  if (MODE == kF32) return static_cast<const float*>(band)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(band)[i]);
}

// TB batch columns per block; TR = kThreads * K / TB rows per block, with
// K = rows per thread. Shared memory (dynamic): window [TR + 2W][TB] then
// band [TR][D | 1] (an odd row stride: 32 rows read at once hit 32 banks).
template <int MODE, int TB, int K>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const void* __restrict__ band, const float* __restrict__ pv,
                float* __restrict__ out, const Offsets offs, int d, int w,
                int npd, int batch, int band_stride) {
  constexpr int TR = kThreads * K / TB;
  extern __shared__ float smem[];
  const int win_rows = TR + 2 * w;
  float* win = smem;                       // [win_rows][TB]
  float* bnd = smem + (size_t)win_rows * TB;  // [TR][d | 1]
  const int bstride = d | 1;

  const int r0 = blockIdx.x * TR;
  const int b0 = blockIdx.y * TB;
  const int tid = threadIdx.x;

  // operand window: rows [r0 - W, r0 + TR + W), columns [b0, b0 + TB)
  for (int e = tid; e < win_rows * TB; e += kThreads) {
    const int wr = e / TB;
    const int c = e % TB;
    const int row = r0 - w + wr;
    float v = 0.f;
    if (row >= 0 && row < npd && b0 + c < batch) v = pv[(size_t)row * batch + b0 + c];
    win[e] = v;
  }
  // band lanes 0..D-1 of rows [r0, r0 + TR)
  for (int e = tid; e < TR * d; e += kThreads) {
    const int rr = e / d;
    const int j = e % d;
    const int row = r0 + rr;
    float v = 0.f;
    if (row < npd) v = load_band<MODE>(band, (size_t)row * band_stride + j);
    bnd[rr * bstride + j] = v;
  }
  __syncthreads();

  const int c = tid % TB;
  const int rbase = tid / TB;
  constexpr int kRowStep = kThreads / TB;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  for (int j = 0; j < d; ++j) {
    const int shift = w + offs.off[j];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int rr = rbase + k * kRowStep;
      acc[k] = fmaf(bnd[rr * bstride + j], win[(rr + shift) * TB + c], acc[k]);
    }
  }
  if (b0 + c < batch) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int row = r0 + rbase + k * kRowStep;
      if (row < npd) out[(size_t)row * batch + b0 + c] = acc[k];
    }
  }
}

template <int MODE, int TB, int K>
int launch(const void* band, const float* pv, float* out, const Offsets& offs,
           int d, int w, int npd, int batch, int band_stride,
           cudaStream_t st) {
  constexpr int TR = kThreads * K / TB;
  const size_t smem = ((size_t)(TR + 2 * w) * TB + (size_t)TR * (d | 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dia_spmv_kernel<MODE, TB, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((npd + TR - 1) / TR, (batch + TB - 1) / TB);
  dia_spmv_kernel<MODE, TB, K><<<grid, kThreads, smem, st>>>(
      band, pv, out, offs, d, w, npd, batch, band_stride);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch_tile(const void* band, const float* pv, float* out,
                  const Offsets& offs, int d, int w, int npd, int batch,
                  int band_stride, cudaStream_t st) {
  // TB = the batch rounded up to a power of two, at most 32; K keeps
  // TR = 256 rows for TB <= 2 and 128 rows above.
  if (batch <= 1)
    return launch<MODE, 1, 1>(band, pv, out, offs, d, w, npd, batch, band_stride, st);
  if (batch <= 2)
    return launch<MODE, 2, 2>(band, pv, out, offs, d, w, npd, batch, band_stride, st);
  if (batch <= 4)
    return launch<MODE, 4, 2>(band, pv, out, offs, d, w, npd, batch, band_stride, st);
  if (batch <= 8)
    return launch<MODE, 8, 4>(band, pv, out, offs, d, w, npd, batch, band_stride, st);
  if (batch <= 16)
    return launch<MODE, 16, 8>(band, pv, out, offs, d, w, npd, batch, band_stride, st);
  return launch<MODE, 32, 16>(band, pv, out, offs, d, w, npd, batch, band_stride, st);
}

}  // namespace

// Plain C entry point (loaded with ctypes). band: f32 (mode 0) or bf16
// (mode 1) [npd, band_stride]; pv, out: f32 [npd, batch]; offsets: host
// array of d ints, each |off| <= w <= 512, copied into the kernel's
// parameters. All device arrays contiguous. Launches on `stream` and
// returns a cudaError_t (0 = launched); arguments out of range launch
// nothing and return cudaErrorInvalidValue.
extern "C" int dia_spmv(const void* band, const float* pv, float* out,
                        const int* offsets, int d, int w, int npd, int batch,
                        int band_stride, int mode, void* stream) {
  if (npd <= 0 || batch <= 0 || d <= 0 || d > kMaxOffsets || d > band_stride ||
      w < 0 || w > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs;
  for (int j = 0; j < kMaxOffsets; ++j) offs.off[j] = 0;
  for (int j = 0; j < d; ++j) {
    if (offsets[j] < -w || offsets[j] > w) return static_cast<int>(cudaErrorInvalidValue);
    offs.off[j] = offsets[j];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      return dispatch_tile<kF32>(band, pv, out, offs, d, w, npd, batch, band_stride, st);
    case kBF16:
      return dispatch_tile<kBF16>(band, pv, out, offs, d, w, npd, batch, band_stride, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
