// Block-ELL Laplacian SpMV for Hopper (sm_90a): out = L_sym @ pv in RCM space.
//
// Replaces the two Pallas TPU kernels of manifold_gp_tpu/ops/pallas_spmv.py:
//   K1  _kernel        (resident_matvec_call): operand resident in VMEM;
//   K2  _kernel_stream (stream_matvec_call):   operand in HBM, slice DMA.
// On a GPU the operand always lives in device memory with L2 as its cache,
// so one kernel serves both entry points (manifold_gp_torch/ops/cuda_spmv.py).
//
// What it computes, per 128-row block r:
//   out[r*128 : r*128+128, :] = panels[r] [128, S*128]
//                               @ concat_s pv[block_col[r,s]*128 : +128, :]
// with three panel types, as on the TPU:
//   mode 0  f32 panels:  exact f32 FMAs (no TF32, no tensor-core emulation);
//   mode 1  bf16 panels: operand rounded to bf16, bf16 x bf16 products (exact
//           in f32) accumulated in f32;
//   mode 2  x3 panels:   stacked [2, nrb, 128, S*128] bf16 (hi, lo); operand
//           split as sh = bf16(v), sl = bf16(v - sh); acc += hi*sh + hi*sl +
//           lo*sh in f32 (the bf16x3 scheme, ~2^-15 relative error).
// Padding slots (block_col = 0 over zero panel columns) are read like any
// other slot, as the TPU kernels read them.
//
// What bounds each mode on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 on
// the tensor cores, ~67 TFLOP/s f32 outside them). A panel element is read
// once and feeds 2*B FLOPs. bf16 and x3 panels give at most 2*128/2 = 128
// FLOP per byte, under the card's ridge point of ~295, so every batch width
// is bound by the panel bytes (262k-point torus, nrb = 2032, S = 22: 1.47 GB
// bf16, 0.44 ms; x3 twice that) once the products run on the tensor cores.
// f32 panels at B = 125 (the basis solve) are bound by operations: 1.8e11
// exact f32 FLOPs, ~2.7 ms on the CUDA cores.
//
// What the design does about it:
//   * The batch tile TB (8, 16, 32, 64 or 128, the smallest >= min(B, 128),
//     picked by the wrapper) is a template parameter. The grid is
//     (row blocks, ceil(B / TB)), so each panel byte is read once for
//     B <= 128 and no product is spent on batch columns that do not exist
//     beyond the next multiple of 8. The ragged edge is never padded in
//     memory: it is zero-filled on load (or left stale, see OperandCopy) and
//     masked on store.
//   * A ring of 3 stages in dynamic shared memory, filled by cp.async:
//     each stage holds a [128, KC] panel tile as it lies in HBM (bf16 stays
//     bf16; KC = 64 for bf16 / x3, 32 for f32) and the [KC, TB] f32 operand
//     tile. The copies of the next stages are in flight while one is
//     multiplied; one barrier per stage. The block's S column ids are read
//     once into shared memory. Operand rows are copied 16 bytes at a time
//     where B % 4 == 0, and as one contiguous run of KC * B floats where a
//     single batch tile covers a ragged B (bf16 / x3).
//   * bf16 / x3: eight warps tile [128, TB] in m16n8 fragments and run
//     mma.sync m16n8k16 (bf16 in, f32 accumulate). Panel fragments come by
//     ldmatrix from rows padded by 16 bytes (conflict-free); the operand
//     fragments are read from the f32 tile (padded row stride TB + 4 floats
//     is conflict-free) and rounded to bf16, or split into (sh, sl), in
//     registers. x3 issues three MMAs per fragment into one accumulator.
//   * f32: 256 threads each own a TM x TN register tile (8 x 8 at TB = 128)
//     and read four k at a time from the row-major panel tile as float4
//     (row stride KC + 4 floats: the two rows a warp reads sit in distinct
//     banks), so each shared-memory float feeds TN or TM FMAs.
//   * blockIdx.x is the row block: neighbouring row blocks of the banded RCM
//     order share most operand slices, which then come from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx_helpers.cuh"

namespace {

constexpr int kBlock = 128;      // rows per row block = column-block width
constexpr int kThreads = 256;    // 8 warps
constexpr int kStages = 3;       // depth of the cp.async ring
constexpr int kMaxSmem = 232448;  // 227 KB, the most one block may ask for

enum PanelMode { kF32 = 0, kBF16 = 1, kX3 = 2 };

// How a stage's operand tile is copied and laid out:
//   kPadded16  [KC][TB + 4], 16-byte copies (B % 4 == 0);
//   kContig16  [KC][B] as it lies in pv, 16-byte copies of the contiguous
//              KC * B floats (one batch tile, B % 4 != 0: bf16 / x3 only);
//   kPadded4   [KC][TB + 4], 4-byte copies (any other ragged batch).
enum OperandCopy { kPadded16 = 0, kContig16 = 1, kPadded4 = 2 };

// One stage of the ring: the panel tile [planes][128][kLda] then the
// operand tile (room for [KC][TB + 4] f32). Both sizes are multiples of
// 16 bytes. KC is the k-depth of a stage.
template <int MODE, int TB>
struct Stage {
  using T = std::conditional_t<MODE == kF32, float, __nv_bfloat16>;
  static constexpr int KC = MODE == kF32 ? 32 : 64;
  static constexpr int kStepsPerSlot = kBlock / KC;
  static constexpr int kPlanes = MODE == kX3 ? 2 : 1;
  static constexpr int kLda = KC + 16 / int(sizeof(T));  // pad one 16-byte chunk
  static constexpr int kLdb = TB + 4;
  static constexpr int kPanelBytes = kPlanes * kBlock * kLda * int(sizeof(T));
  static constexpr int kBytes = kPanelBytes + KC * kLdb * 4;
};

// Issue the copies of k-step `step` (columns (step % kStepsPerSlot) * KC of
// slot step / kStepsPerSlot) into `stage`.
template <int MODE, int TB>
__device__ __forceinline__ void load_stage(unsigned char* stage, const void* panels, size_t width,
                                           size_t plane, const float* pv, const int* bc_s,
                                           int r, int batch, int b0, int step, int copy,
                                           int tid) {
  using S = Stage<MODE, TB>;
  using T = typename S::T;
  constexpr int KC = S::KC;
  const int slot = step / S::kStepsPerSlot;
  const int k0 = (step % S::kStepsPerSlot) * KC;
  constexpr int kPer16 = 16 / int(sizeof(T));  // elements per 16-byte chunk
  constexpr int kChunksPerRow = KC / kPer16;
  T* a_s = reinterpret_cast<T*>(stage);
  const T* src = static_cast<const T*>(panels) + (size_t)r * kBlock * width +
                 (size_t)slot * kBlock + k0;
  static_assert(kBlock * kChunksPerRow % kThreads == 0, "whole panel chunks per thread");
#pragma unroll
  for (int i = 0; i < kBlock * kChunksPerRow / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int row = e / kChunksPerRow;
    const int c = (e % kChunksPerRow) * kPer16;
    const T* g = src + (size_t)row * width + c;
    cp_async16(a_s + row * S::kLda + c, g);
    if constexpr (MODE == kX3) cp_async16(a_s + (kBlock + row) * S::kLda + c, g + plane);
  }
  // Operand tile: KC rows of the slot, TB batch columns from b0. Padded
  // copies zero-fill the columns at or past `batch` without reading them;
  // the contiguous copy leaves them stale, which only reaches output
  // columns that are never stored.
  float* b_s = reinterpret_cast<float*>(stage + S::kPanelBytes);
  const float* rows = pv + ((size_t)bc_s[slot] * kBlock + k0) * batch + b0;
  if (copy == kContig16) {  // b0 = 0; the KC * batch floats start 16-byte aligned
    for (int e = tid; e < KC * batch / 4; e += kThreads) cp_async16(b_s + 4 * e, rows + 4 * e);
  } else if (copy == kPadded16) {  // every operand row starts 16-byte aligned
    constexpr int kChunks = KC * TB / 4;
#pragma unroll
    for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / (TB / 4);
      const int j = (e % (TB / 4)) * 4;
      const bool in = b0 + j < batch;
      if (kChunks % kThreads == 0 || e < kChunks)
        cp_async16(b_s + kk * S::kLdb + j, in ? rows + (size_t)kk * batch + j : pv, in ? 16 : 0);
    }
  } else {
    static_assert(KC * TB % kThreads == 0, "whole operand elements per thread");
#pragma unroll
    for (int i = 0; i < KC * TB / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / TB;
      const int j = e % TB;
      const bool in = b0 + j < batch;
      cp_async4(b_s + kk * S::kLdb + j, in ? rows + (size_t)kk * batch + j : pv, in ? 4 : 0);
    }
  }
}

// bf16 / x3 panels: tensor-core tile. Warps are laid out WM x WN over
// [128, TB]; each owns MT x NT fragments of m16 x n8.
template <int MODE, int TB>
struct MmaTile {
  using S = Stage<MODE, TB>;
  static constexpr int NT = TB >= 64 ? 4 : (TB >= 16 ? 2 : 1);
  static constexpr int WN = TB / (8 * NT);
  static constexpr int WM = 8 / WN;
  static constexpr int MT = kBlock / (16 * WM);
  float acc[MT][NT][4];
  int wm, wn, lane;

  __device__ __forceinline__ explicit MmaTile(int tid) {
    lane = tid % 32;
    wm = (tid / 32) / WN;
    wn = (tid / 32) % WN;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
  }

  // `ldb`: the operand tile's row stride (TB + 4, or B when contiguous)
  __device__ __forceinline__ void multiply(const unsigned char* stage, int ldb) {
    const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(stage);
    const float* b_s = reinterpret_cast<const float*>(stage + S::kPanelBytes);
#pragma unroll
    for (int k16 = 0; k16 < S::KC; k16 += 16) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // lanes 0-15: rows 0-15 at k16; lanes 16-31: rows 0-15 at k16 + 8
        const int off = ((wm * MT + m) * 16 + (lane % 16)) * S::kLda + k16 + (lane / 16) * 8;
        ldmatrix_x4(ah[m], a_s + off);
        if constexpr (MODE == kX3) ldmatrix_x4(al[m], a_s + kBlock * S::kLda + off);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // B fragment: k = 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1), column g
        const float* bp = b_s + (k16 + 2 * (lane % 4)) * ldb + (wn * NT + n) * 8 + lane / 4;
        const float x0 = bp[0], x1 = bp[ldb], x2 = bp[8 * ldb], x3 = bp[9 * ldb];
        const uint32_t bh[2] = {pack_bf16x2(x0, x1), pack_bf16x2(x2, x3)};
        if constexpr (MODE == kX3) {
          const uint32_t bl[2] = {pack_bf16x2(bf16_residual(x0), bf16_residual(x1)),
                                  pack_bf16x2(bf16_residual(x2), bf16_residual(x3))};
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16_16816(acc[m][n], ah[m], bh);
            mma_bf16_16816(acc[m][n], ah[m], bl);
            mma_bf16_16816(acc[m][n], al[m], bh);
          }
        } else {
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16_16816(acc[m][n], ah[m], bh);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* out, int r, int b0, int batch) const {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int row = r * kBlock + (wm * MT + m) * 16 + lane / 4;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = b0 + (wn * NT + n) * 8 + 2 * (lane % 4);
        float* lo = out + (size_t)row * batch + c;
        float* hi = lo + (size_t)8 * batch;
        if (c < batch) { lo[0] = acc[m][n][0]; hi[0] = acc[m][n][2]; }
        if (c + 1 < batch) { lo[1] = acc[m][n][1]; hi[1] = acc[m][n][3]; }
      }
    }
  }
};

// f32 panels: exact FMAs on the CUDA cores. Threads are laid out RG x CG
// over [128, TB]; each owns TM rows x TN columns.
template <int TB>
struct FmaTile {
  using S = Stage<kF32, TB>;
  static constexpr int CG = TB < 16 ? TB : 16;
  static constexpr int TN = TB / CG;        // 1, 2, 4 or 8
  static constexpr int RG = kThreads / CG;
  static constexpr int TM = kBlock / RG;    // 4 or 8
  float acc[TM][TN];
  int tx, ty;

  // rows ty*4 + {0..3} (and 64 + ty*4 + {0..3} when TM = 8); columns
  // tx*TN + j, or tx*4 + {0..3} and TB/2 + tx*4 + {0..3} when TN = 8
  __device__ __forceinline__ int row(int i) const { return (i / 4) * (kBlock / 2) + ty * 4 + i % 4; }
  __device__ __forceinline__ int col(int j) const {
    return TN == 8 ? (j / 4) * (TB / 2) + tx * 4 + j % 4 : tx * TN + j;
  }

  __device__ __forceinline__ explicit FmaTile(int tid) {
    tx = tid % CG;
    ty = tid / CG;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  // the operand tile is always padded here (ldb = TB + 4)
  __device__ __forceinline__ void multiply(const unsigned char* stage, int) {
    const float* a_s = reinterpret_cast<const float*>(stage);
    const float* b_s = reinterpret_cast<const float*>(stage + S::kPanelBytes);
#pragma unroll
    for (int k4 = 0; k4 < S::KC; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_s + row(i) * S::kLda + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* bk = b_s + (k4 + q) * S::kLdb;
        float b[TN];
        if constexpr (TN >= 4) {
#pragma unroll
          for (int h = 0; h < TN / 4; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(bk + col(4 * h));
            b[4 * h] = v.x; b[4 * h + 1] = v.y; b[4 * h + 2] = v.z; b[4 * h + 3] = v.w;
          }
        } else if constexpr (TN == 2) {
          const float2 v = *reinterpret_cast<const float2*>(bk + col(0));
          b[0] = v.x; b[1] = v.y;
        } else {
          b[0] = bk[col(0)];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* out, int r, int b0, int batch) const {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float* dst = out + ((size_t)r * kBlock + row(i)) * batch + b0;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (b0 + col(j) < batch) dst[col(j)] = acc[i][j];
    }
  }
};

template <int MODE, int TB>
__global__ void __launch_bounds__(kThreads, 1)
block_ell_spmv_kernel(const void* __restrict__ panels, const int* __restrict__ block_col,
                      const float* __restrict__ pv, float* __restrict__ out, int nrb,
                      int s_max, int batch) {
  using S = Stage<MODE, TB>;
  using Tile = std::conditional_t<MODE == kF32, FmaTile<TB>, MmaTile<MODE, TB>>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* bc_s = reinterpret_cast<int*>(smem + kStages * S::kBytes);

  const int r = blockIdx.x;
  const int b0 = blockIdx.y * TB;
  const int tid = threadIdx.x;
  const size_t width = (size_t)s_max * kBlock;
  const size_t plane = (size_t)nrb * kBlock * width;  // x3: offset of lo
  const int n_steps = s_max * S::kStepsPerSlot;
  const bool aligned = reinterpret_cast<uintptr_t>(pv) % 16 == 0;
  const int copy = aligned && batch % 4 == 0 ? kPadded16
                   : aligned && MODE != kF32 && gridDim.y == 1 ? kContig16
                   : kPadded4;
  const int ldb = copy == kContig16 ? batch : S::kLdb;

  for (int s = tid; s < s_max; s += kThreads) bc_s[s] = block_col[(size_t)r * s_max + s];
  __syncthreads();

  Tile tile(tid);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_steps)
      load_stage<MODE, TB>(smem + t * S::kBytes, panels, width, plane, pv, bc_s, r, batch, b0,
                           t, copy, tid);
    cp_async_commit();
  }
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step t have landed
    __syncthreads();               // everyone's have; step t - 1 is consumed
    const int next = t + kStages - 1;
    if (next < n_steps)
      load_stage<MODE, TB>(smem + (next % kStages) * S::kBytes, panels, width, plane, pv, bc_s,
                           r, batch, b0, next, copy, tid);
    cp_async_commit();
    tile.multiply(smem + (t % kStages) * S::kBytes, ldb);
  }
  tile.store(out, r, b0, batch);
}

template <int MODE, int TB>
cudaError_t launch(const void* panels, const int* block_col, const float* pv, float* out,
                   int nrb, int s_max, int batch, cudaStream_t st) {
  using S = Stage<MODE, TB>;
  const size_t smem = (size_t)kStages * S::kBytes + (size_t)s_max * sizeof(int);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto* kernel = block_ell_spmv_kernel<MODE, TB>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nrb, (batch + TB - 1) / TB);
  kernel<<<grid, kThreads, smem, st>>>(panels, block_col, pv, out, nrb, s_max, batch);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_tile(int batch_tile, const void* panels, const int* block_col, const float* pv,
                        float* out, int nrb, int s_max, int batch, cudaStream_t st) {
  switch (batch_tile) {
    case 8: return launch<MODE, 8>(panels, block_col, pv, out, nrb, s_max, batch, st);
    case 16: return launch<MODE, 16>(panels, block_col, pv, out, nrb, s_max, batch, st);
    case 32: return launch<MODE, 32>(panels, block_col, pv, out, nrb, s_max, batch, st);
    case 64: return launch<MODE, 64>(panels, block_col, pv, out, nrb, s_max, batch, st);
    case 128: return launch<MODE, 128>(panels, block_col, pv, out, nrb, s_max, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). panels: f32 [nrb,128,S*128]
// (mode 0), bf16 [nrb,128,S*128] (mode 1) or bf16 [2,nrb,128,S*128]
// (mode 2); block_col: int32 [nrb*S]; pv: f32 [rows, batch] with every
// block_col id < rows/128; out: f32 [nrb*128, batch]. All contiguous.
// batch_tile: 8, 16, 32, 64 or 128 batch columns per thread block.
// Launches on `stream` and returns cudaGetLastError() (0 = launched); an
// empty problem, an unknown mode or tile, or an S too large for shared
// memory launches nothing and returns cudaErrorInvalidValue.
extern "C" int block_ell_spmv(const void* panels, const int* block_col, const float* pv,
                              float* out, int nrb, int s_max, int batch, int mode,
                              int batch_tile, void* stream) {
  if (nrb <= 0 || batch <= 0 || s_max <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kF32:
      err = launch_tile<kF32>(batch_tile, panels, block_col, pv, out, nrb, s_max, batch, st);
      break;
    case kBF16:
      err = launch_tile<kBF16>(batch_tile, panels, block_col, pv, out, nrb, s_max, batch, st);
      break;
    case kX3:
      err = launch_tile<kX3>(batch_tile, panels, block_col, pv, out, nrb, s_max, batch, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
