// Panel cotangent of the block-ELL SpMV for Hopper (sm_90a):
//   bar_blocks[r, :, s*128 : (s+1)*128] = g[r*128 : +128, :] [128, B]
//                                         @ pv[block_col[r,s]*128 : +128, :]^T [B, 128]
//
// Replaces the Pallas TPU kernel K3 of manifold_gp_tpu/ops/pallas_spmv.py:
//   _kernel_bwd_blocks (bwd_blocks_call, wrapper
//   block_bwd_blocks_pallas_streaming).
// It is the backward of block_ell_spmv.cu with respect to the panels: every
// solve / log-det VJP of training calls it through the autograd Functions
// of manifold_gp_torch/ops/cuda_spmv.py, and the gathered operand
// [nrb, S*128, B] is never written to device memory.
//
// Two output types, as on the TPU:
//   mode 0  f32:  exact f32 FMAs (no TF32), f32 result;
//   mode 1  bf16: g and the operand rounded to bf16 (nearest even),
//           bf16 x bf16 products (exact in f32) accumulated in f32 on the
//           tensor cores, the result rounded to bf16 once, on store.
// Padding slots (block_col = 0 over slots the assembly never fills) receive
// g[r] @ pv[0:128]^T like any other slot, as the TPU kernel writes them; no
// consumer reads them.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 outside the
// tensor cores, 989 bf16 on them). Bytes: the output, nrb*128*S*128 *
// itemsize, written once, and g, the operand and the ids read once.
// Operations: 2*nrb*128*S*128*B. At the 262k-node torus (nrb = 2032,
// S = 22) the f32 output is 2.93 GB (0.87 ms of writes) and the bf16 one
// 1.47 GB (0.44 ms). f32 at B = 48: 7.0e10 FLOPs, 1.05 ms, bound by
// operations; f32 at B = 1 and bf16 at B = 1 and 48: bound by the output
// bytes (0.875, 0.438, 0.467 ms). The contraction is short (K = B): the
// output write is the largest stream of every case.
//
// What the design does about it:
//   * One thread block per row block r walks its S output tiles. g[r]
//     [128, B] is staged once and stays in shared memory for all S tiles
//     (B <= 64); the S column ids are read once. Neighbouring row blocks of
//     the banded RCM order share most operand slices, which then come from
//     L2.
//   * A 2-stage ring of operand slices [128, B] in dynamic shared memory,
//     filled by cp.async: slice s+1 is in flight while s is multiplied. A
//     128-row slice of a row-major [rows, B] tensor is one contiguous run,
//     copied 16 bytes at a time where B % 4 == 0 (4 bytes otherwise) into
//     rows padded for conflict-free fragment reads. (At a ragged B a flat
//     16-byte copy of the run would land rows at stride B; moving them to
//     the padded stride writes as many shared floats as the 4-byte copies
//     do, plus a barrier.) The batch is never
//     padded in memory: columns up to the next multiple of 4 (f32) or 16
//     (bf16, the mma depth) are zero-filled by the copies.
//   * The batch class KB (16, 32 or 64 columns of shared memory, picked by
//     the wrapper: cuda_spmv._bwd_batch_class) is a template parameter.
//     Above 64 the contraction runs in 32-column chunks through the same
//     ring, each stage then carrying its g chunk too; the f32 accumulators
//     persist across chunks, so the result is still rounded once.
//   * bf16: eight warps (2 x 4) each own a 64 x 32 block of the 128 x 128
//     tile as 4 x 4 fragments of mma.sync m16n8k16 (bf16 in, f32
//     accumulate: 64 accumulators a thread). g is the row-major A operand
//     and the operand slice, [j][k] as it lies in memory, exactly the
//     column-major B operand; both fragments are read from the f32 tiles as
//     float2 (row stride KB + 8 floats: conflict-free) and rounded to bf16
//     in registers with the plain version's rounding.
//   * f32: 256 threads each own an 8 x 8 register tile (rows in four-row
//     runs, columns 16 apart) and read four k at a time of both factors as
//     float4 (row stride KB + 4 floats: eight consecutive rows fall in
//     distinct bank groups), so each shared-memory float feeds 8 FMAs.
//   * The epilogue overlaps the next tile and keeps out of L2's way: every
//     template fits two blocks on an SM (at most 128 registers a thread and
//     113 KB of shared memory), so one block's stores run while the other
//     multiplies, and every output store is evict-first (st.global.cs). f32
//     stores straight from the register tile (a half-warp writes 64
//     contiguous bytes of a row); bf16 rounds the tile into a staging
//     buffer in shared memory (the stage just multiplied, where it is large
//     enough) and copies it out in coalesced 16-byte stores, since one
//     mma fragment holds only 16 bytes of a row. Chosen on the card over
//     one block per SM with a bulk asynchronous copy (cp.async.bulk, one
//     per 512- or 256-byte row), which was slower in both modes (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx_helpers.cuh"

namespace {

constexpr int kBlock = 128;       // rows per row block = column-block width
constexpr int kThreads = 256;     // 8 warps
constexpr int kStages = 2;        // depth of the operand ring
constexpr int kChunk = 32;        // batch columns per chunk above 64
constexpr int kMaxSmem = 232448;  // 227 KB, the most one block may ask for

enum OutMode { kOutF32 = 0, kOutBF16 = 1 };

// Shared-memory geometry of one template: [g tile (resident) | kStages
// stages | bf16 output staging where a stage cannot hold it | column ids].
// KB: batch columns a factor tile holds; CHUNKED: the batch runs in
// KB-wide chunks and each stage carries its g chunk after the operand tile.
// Every template fits two blocks on an SM (at most 113 KB each).
template <int MODE, int KB, bool CHUNKED>
struct Geo {
  using TOut = std::conditional_t<MODE == kOutF32, float, __nv_bfloat16>;
  // f32: (KB + 4) / 4 is odd, so the float4 reads of eight consecutive rows
  // hit eight distinct bank groups; bf16: KB + 8 is 8 or 24 mod 32, so the
  // float2 fragment reads of four rows x four k pairs hit 32 banks.
  static constexpr int kLd = KB + (MODE == kOutF32 ? 4 : 8);
  static constexpr int kTileBytes = kBlock * kLd * 4;
  static constexpr int kGBytes = CHUNKED ? 0 : kTileBytes;
  static constexpr int kStageBytes = (CHUNKED ? 2 : 1) * kTileBytes;
  // bf16 output staging [128][136]: rows padded by 16 bytes (16-byte
  // aligned, and the fragment writes of a warp hit 32 banks). It reuses the
  // stage just multiplied where that stage is large enough.
  static constexpr int kOutLd = kBlock + 8;
  static constexpr int kStagingBytes = kBlock * kOutLd * 2;
  static constexpr bool kOwnStaging = MODE == kOutBF16 && kStagingBytes > kStageBytes;
  static constexpr int kOutBytes = kOwnStaging ? kStagingBytes : 0;
  static constexpr int kBytes = kGBytes + kStages * kStageBytes + kOutBytes;
  static_assert(kBytes <= 113 * 1024, "two blocks per SM");
};

// The k extent a chunk of `kc` columns is multiplied over: f32 four at a
// time, bf16 in steps of the mma depth 16. Columns [kc, extent) are zero.
template <int MODE>
__device__ __forceinline__ int k_extent(int kc) {
  return MODE == kOutF32 ? (kc + 3) & ~3 : (kc + 15) & ~15;
}

// Issue the copies of a [128, ke] f32 tile into dst [128][LD]: row i from
// src + i * batch, columns [0, kc) read, [kc, ke) zero-filled. Each thread
// keeps one column chunk and steps over rows (one division per call).
template <int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int batch, int kc,
                                          int ke, bool vec16, int tid) {
  const int w = vec16 ? 4 : 1;  // floats per copy; vec16: kc % 4 == 0, rows 16-byte aligned
  const int per_row = ke / w;
  const int row_step = kThreads / per_row;
  const int row0 = tid / per_row;
  const int c = (tid - row0 * per_row) * w;
  if (row0 >= row_step) return;  // the threads past the last whole row
  const bool in = c < kc;  // else zero-fill, reading nothing (src stays a valid address)
  const float* from = src + (in ? (size_t)row0 * batch + c : 0);
  const size_t from_step = in ? (size_t)row_step * batch : 0;
  for (int row = row0; row < kBlock; row += row_step, from += from_step) {
    if (vec16)
      cp_async16(dst + row * LD + c, from, in ? 16 : 0);
    else
      cp_async4(dst + row * LD + c, from, in ? 4 : 0);
  }
}

// f32: exact FMAs on the CUDA cores. Threads tx (16) x ty (16); thread
// rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns tx + 16*j.
template <int LD>
struct FmaTile {
  float acc[8][8];
  int tx, ty;

  __device__ __forceinline__ explicit FmaTile(int tid) : tx(tid % 16), ty(tid / 16) {}
  __device__ __forceinline__ int row(int i) const { return (i / 4) * 64 + ty * 4 + i % 4; }
  __device__ __forceinline__ int col(int j) const { return j * 16 + tx; }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  // a_s: g [128][LD], b_s: the operand slice [128][LD]; k over [0, ke)
  __device__ __forceinline__ void multiply(const float* a_s, const float* b_s, int ke) {
#pragma unroll 1
    for (int k4 = 0; k4 < ke; k4 += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(a_s + row(i) * LD + k4);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(b_s + col(j) * LD + k4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }

  // straight to the output tile (row stride `width`) with evict-first
  // stores: a half-warp writes 64 contiguous bytes of a row
  __device__ __forceinline__ void store(float* dst, size_t width) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) __stcs(dst + row(i) * width + col(j), acc[i][j]);
  }
};

// bf16: tensor cores. Warps 2 (rows) x 4 (columns), each 64 x 32 of the
// tile as 4 x 4 fragments m16 x n8.
template <int LD>
struct MmaTile {
  float acc[4][4][4];
  int wm, wn, lane;

  __device__ __forceinline__ explicit MmaTile(int tid)
      : wm((tid / 32) / 4), wn((tid / 32) % 4), lane(tid % 32) {}

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
  }

  __device__ __forceinline__ static uint32_t pack(const float* p) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    return pack_bf16x2(v.x, v.y);
  }

  // a_s: g [128][LD] (A, row-major: rows i, k contiguous); b_s: the operand
  // slice [128][LD] (B, column-major: columns j, k contiguous)
  __device__ __forceinline__ void multiply(const float* a_s, const float* b_s, int ke) {
    const int gr = lane / 4;            // fragment row / column
    const int kt = 2 * (lane % 4);      // fragment k pair
#pragma unroll 1
    for (int k16 = 0; k16 < ke; k16 += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* p = b_s + (wn * 32 + n * 8 + gr) * LD + k16 + kt;
        b[n][0] = pack(p);
        b[n][1] = pack(p + 8);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {  // one A fragment live at a time
        const float* p = a_s + (wm * 64 + m * 16 + gr) * LD + k16 + kt;
        const uint32_t a[4] = {pack(p), pack(p + 8 * LD), pack(p + 8), pack(p + 8 * LD + 8)};
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_bf16_16816(acc[m][n], a, b[n]);
      }
    }
  }

  // rounded once into the staging tile [128][out_ld] bf16: a warp writes
  // eight rows x four bf16 pairs, 32 distinct banks (out_ld / 2 = 4 mod 32);
  // then all threads copy it out in coalesced 16-byte evict-first stores
  // (a fragment's own pairs would cover only 16 bytes of a row)
  __device__ __forceinline__ void store(__nv_bfloat16* dst, size_t width,
                                        __nv_bfloat16* out_s, int out_ld, int tid) const {
    __syncthreads();  // the staging tile is free
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int row = wm * 64 + m * 16 + lane / 4;
        const int c = wn * 32 + n * 8 + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(out_s + row * out_ld + c) =
            __floats2bfloat162_rn(acc[m][n][0], acc[m][n][1]);
        *reinterpret_cast<__nv_bfloat162*>(out_s + (row + 8) * out_ld + c) =
            __floats2bfloat162_rn(acc[m][n][2], acc[m][n][3]);
      }
    __syncthreads();
    // thread: 16-byte chunk tid % 16 of rows tid / 16 + 16 * i
    constexpr int kRowStep = kThreads / (kBlock / 8);
    const int row0 = tid / (kBlock / 8);
    const int c = (tid % (kBlock / 8)) * 8;
    const __nv_bfloat16* src = out_s + row0 * out_ld + c;
    __nv_bfloat16* to = dst + row0 * width + c;
#pragma unroll 1  // measured: faster than unrolled
    for (int i = 0; i < kBlock / kRowStep; ++i)
      __stcs(reinterpret_cast<uint4*>(to + i * kRowStep * width),
             *reinterpret_cast<const uint4*>(src + i * kRowStep * out_ld));
  }
};

template <int MODE, int KB, bool CHUNKED>
__global__ void __launch_bounds__(kThreads, 2)
block_ell_bwd_blocks_kernel(const float* __restrict__ g, const int* __restrict__ block_col,
                            const float* __restrict__ pv, void* __restrict__ out, int s_max,
                            int batch) {
  using G = Geo<MODE, KB, CHUNKED>;
  using TOut = typename G::TOut;
  using Tile = std::conditional_t<MODE == kOutF32, FmaTile<G::kLd>, MmaTile<G::kLd>>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* g_res = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + G::kGBytes;
  __nv_bfloat16* own_staging = reinterpret_cast<__nv_bfloat16*>(ring + kStages * G::kStageBytes);
  int* bc_s = reinterpret_cast<int*>(ring + kStages * G::kStageBytes + G::kOutBytes);

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_chunks = CHUNKED ? (batch + KB - 1) / KB : 1;
  const int n_steps = s_max * n_chunks;
  const bool vec16 = batch % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(pv) % 16 == 0;
  const float* g_rows = g + (size_t)r * kBlock * batch;
  const size_t width = (size_t)s_max * kBlock;

  for (int s = tid; s < s_max; s += kThreads) bc_s[s] = block_col[(size_t)r * s_max + s];
  __syncthreads();

  // step t = (tile t / n_chunks, chunk t % n_chunks)
  auto load_step = [&](int t) {
    const int s = t / n_chunks;
    const int c = t - s * n_chunks;
    const int kc = CHUNKED ? min(KB, batch - c * KB) : batch;
    const int ke = k_extent<MODE>(kc);
    float* dst = reinterpret_cast<float*>(ring + (t % kStages) * G::kStageBytes);
    load_tile<G::kLd>(dst, pv + (size_t)bc_s[s] * kBlock * batch + c * KB, batch, kc, ke, vec16,
                      tid);
    if (CHUNKED)
      load_tile<G::kLd>(dst + kBlock * G::kLd, g_rows + c * KB, batch, kc, ke, vec16, tid);
  };

  if (!CHUNKED)  // resident g, in the first group
    load_tile<G::kLd>(g_res, g_rows, batch, batch, k_extent<MODE>(batch), vec16, tid);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_steps) load_step(t);
    cp_async_commit();
  }

  Tile tile(tid);
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step t have landed
    __syncthreads();               // everyone's have; step t - 1 is consumed
    if (t + kStages - 1 < n_steps) load_step(t + kStages - 1);
    cp_async_commit();

    const int s = t / n_chunks;
    const int c = t - s * n_chunks;
    const float* b_s = reinterpret_cast<const float*>(ring + (t % kStages) * G::kStageBytes);
    const float* a_s = CHUNKED ? b_s + kBlock * G::kLd : g_res;
    if (c == 0) tile.zero();
    tile.multiply(a_s, b_s, k_extent<MODE>(CHUNKED ? min(KB, batch - c * KB) : batch));
    if (c + 1 < n_chunks) continue;

    TOut* dst = static_cast<TOut*>(out) + (size_t)r * kBlock * width + (size_t)s * kBlock;
    if constexpr (MODE == kOutF32) {
      tile.store(dst, width);
    } else {  // staged in the stage just multiplied, or in its own buffer
      __nv_bfloat16* staging =
          G::kOwnStaging ? own_staging
                         : reinterpret_cast<__nv_bfloat16*>(ring + (t % kStages) * G::kStageBytes);
      tile.store(dst, width, staging, G::kOutLd, tid);
    }
  }
}

template <int MODE, int KB, bool CHUNKED>
cudaError_t launch(const float* g, const int* block_col, const float* pv, void* out, int nrb,
                   int s_max, int batch, cudaStream_t st) {
  using G = Geo<MODE, KB, CHUNKED>;
  const size_t smem = (size_t)G::kBytes + (size_t)s_max * sizeof(int);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto* kernel = block_ell_bwd_blocks_kernel<MODE, KB, CHUNKED>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<nrb, kThreads, smem, st>>>(g, block_col, pv, out, s_max, batch);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_class(int batch_class, const float* g, const int* block_col, const float* pv,
                         void* out, int nrb, int s_max, int batch, cudaStream_t st) {
  switch (batch_class) {
    case 16:
      if (batch > 16) break;
      return launch<MODE, 16, false>(g, block_col, pv, out, nrb, s_max, batch, st);
    case kChunk:
      if (batch <= kChunk)
        return launch<MODE, kChunk, false>(g, block_col, pv, out, nrb, s_max, batch, st);
      if (batch > 64)
        return launch<MODE, kChunk, true>(g, block_col, pv, out, nrb, s_max, batch, st);
      break;
    case 64:
      if (batch > 64) break;
      return launch<MODE, 64, false>(g, block_col, pv, out, nrb, s_max, batch, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). g: f32 [nrb*128, batch];
// block_col: int32 [nrb*S]; pv: f32 [rows, batch] with every block_col id
// < rows/128; out: f32 (mode 0) or bf16 (mode 1) [nrb, 128, S*128]. All
// contiguous. batch_class: 16 (batch <= 16), 32 (batch <= 32, or > 64 in
// 32-column chunks) or 64 (batch <= 64): cuda_spmv._bwd_batch_class. Launches
// on `stream` and returns cudaGetLastError() (0 = launched); an empty
// problem, an unknown mode or a class that does not hold the batch
// launches nothing and returns cudaErrorInvalidValue.
extern "C" int block_ell_bwd_blocks(const float* g, const int* block_col, const float* pv,
                                    void* out, int nrb, int s_max, int batch, int out_mode,
                                    int batch_class, void* stream) {
  if (nrb <= 0 || batch <= 0 || s_max <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (out_mode) {
    case kOutF32:
      err = launch_class<kOutF32>(batch_class, g, block_col, pv, out, nrb, s_max, batch, st);
      break;
    case kOutBF16:
      err = launch_class<kOutBF16>(batch_class, g, block_col, pv, out, nrb, s_max, batch, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
