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
// What bounds it on an H100 SXM (3.35 TB/s HBM, ~67 TFLOP/s f32 outside the
// tensor cores; nvidia-smi names the part "NVIDIA H100 80GB HBM3"). At the
// main path's shape (262k-node torus, nrb = 2032, S = 22, B = 125) the f32
// panels are 2.9 GB, about 0.9 ms of HBM, while the
// product is 2*nrb*128*S*128*B = 1.8e11 f32 FLOPs, about 2.7 ms: exact f32 on
// the CUDA cores is compute-bound at B = 125. (bf16 and x3 panels would be
// bound by bytes if their products ran on the tensor cores; here they run on
// the CUDA cores too.)
//
// What this simple design does about it: every thread block owns one row
// block and one 128-wide batch tile, so each panel byte is read from HBM
// exactly once for B <= 128, and the operand slices (S*128 rows of pv per
// row block, shared by neighbouring row blocks of the banded RCM order) come
// mostly from L2. The 256 threads each hold an 8 x 8 register tile of the
// [128, 128] accumulator and stream the k dimension through shared memory
// in KC-deep slices, so each shared-memory float feeds 8 FMAs. A ragged
// batch edge (B = 1, 37, 125, ...) is masked, not padded. Not done yet:
// cp.async/TMA pipelining, wgmma for the bf16/x3 panels, warp
// specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;    // rows per row block = column-block width
constexpr int kTileB = 128;    // batch columns per thread block
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each

enum PanelMode { kF32 = 0, kBF16 = 1, kX3 = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MODE>
__device__ __forceinline__ float load_panel(const void* panels, size_t off) {
  if (MODE == kF32) return static_cast<const float*>(panels)[off];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(panels)[off]);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
block_ell_spmv_kernel(const void* __restrict__ panels,
                      const int* __restrict__ block_col,
                      const float* __restrict__ pv, float* __restrict__ out,
                      int nrb, int s_max, int batch) {
  constexpr int KC = (MODE == kX3) ? 16 : 32;  // k-depth per staged slice
  constexpr int NP = (MODE == kX3) ? 2 : 1;    // planes: (hi, lo) / (sh, sl)
  constexpr int kPadA = 4;                     // keeps float4 rows aligned
  __shared__ __align__(16) float a_s[NP][KC][kBlock + kPadA];
  __shared__ __align__(16) float b_s[NP][KC][kTileB];

  const int r = blockIdx.x;
  const int b0 = blockIdx.y * kTileB;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t width = (size_t)s_max * kBlock;
  const size_t plane = (size_t)nrb * kBlock * width;  // x3: offset of lo
  const size_t panel_row0 = (size_t)r * kBlock * width;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < s_max; ++s) {
    const int col = block_col[(size_t)r * s_max + s];
    const float* slice = pv + (size_t)col * kBlock * batch;
    for (int k0 = 0; k0 < kBlock; k0 += KC) {
      // Panel tile [128 rows, KC] -> a_s[k][row]; consecutive threads read
      // consecutive k of one panel row.
      for (int e = tid; e < kBlock * KC; e += kThreads) {
        const int row = e / KC;
        const int kk = e % KC;
        const size_t off = panel_row0 + (size_t)row * width +
                           (size_t)s * kBlock + k0 + kk;
        a_s[0][kk][row] = load_panel<MODE>(panels, off);
        if (MODE == kX3) a_s[NP - 1][kk][row] = load_panel<MODE>(panels, plane + off);
      }
      // Operand tile [KC, 128 batch] -> b_s[k][col]; the ragged batch edge
      // reads zeros.
      for (int e = tid; e < KC * kTileB; e += kThreads) {
        const int kk = e / kTileB;
        const int j = e % kTileB;
        float v = 0.f;
        if (b0 + j < batch) v = slice[(size_t)(k0 + kk) * batch + b0 + j];
        if (MODE == kF32) {
          b_s[0][kk][j] = v;
        } else if (MODE == kBF16) {
          b_s[0][kk][j] = round_bf16(v);
        } else {
          const float h = round_bf16(v);
          b_s[0][kk][j] = h;
          b_s[NP - 1][kk][j] = round_bf16(v - h);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise in tx
        float a[8], b[8];
        const float4 a_lo4 = *reinterpret_cast<const float4*>(&a_s[0][kk][ty * 4]);
        const float4 a_hi4 = *reinterpret_cast<const float4*>(&a_s[0][kk][64 + ty * 4]);
        const float4 b_lo4 = *reinterpret_cast<const float4*>(&b_s[0][kk][tx * 4]);
        const float4 b_hi4 = *reinterpret_cast<const float4*>(&b_s[0][kk][64 + tx * 4]);
        a[0] = a_lo4.x; a[1] = a_lo4.y; a[2] = a_lo4.z; a[3] = a_lo4.w;
        a[4] = a_hi4.x; a[5] = a_hi4.y; a[6] = a_hi4.z; a[7] = a_hi4.w;
        b[0] = b_lo4.x; b[1] = b_lo4.y; b[2] = b_lo4.z; b[3] = b_lo4.w;
        b[4] = b_hi4.x; b[5] = b_hi4.y; b[6] = b_hi4.z; b[7] = b_hi4.w;
        if (MODE == kX3) {
          float al[8], bl[8];
          const float4 al_lo4 = *reinterpret_cast<const float4*>(&a_s[NP - 1][kk][ty * 4]);
          const float4 al_hi4 = *reinterpret_cast<const float4*>(&a_s[NP - 1][kk][64 + ty * 4]);
          const float4 bl_lo4 = *reinterpret_cast<const float4*>(&b_s[NP - 1][kk][tx * 4]);
          const float4 bl_hi4 = *reinterpret_cast<const float4*>(&b_s[NP - 1][kk][64 + tx * 4]);
          al[0] = al_lo4.x; al[1] = al_lo4.y; al[2] = al_lo4.z; al[3] = al_lo4.w;
          al[4] = al_hi4.x; al[5] = al_hi4.y; al[6] = al_hi4.z; al[7] = al_hi4.w;
          bl[0] = bl_lo4.x; bl[1] = bl_lo4.y; bl[2] = bl_lo4.z; bl[3] = bl_lo4.w;
          bl[4] = bl_hi4.x; bl[5] = bl_hi4.y; bl[6] = bl_hi4.z; bl[7] = bl_hi4.w;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
              acc[i][j] = fmaf(a[i], bl[j], acc[i][j]);
              acc[i][j] = fmaf(al[i], b[j], acc[i][j]);
            }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    float* dst = out + ((size_t)r * kBlock + row) * batch;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = b0 + ((j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < batch) dst[c] = acc[i][j];
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). panels: f32 [nrb,128,S*128]
// (mode 0), bf16 [nrb,128,S*128] (mode 1) or bf16 [2,nrb,128,S*128]
// (mode 2); block_col: int32 [nrb*S]; pv: f32 [rows, batch] with every
// block_col id < rows/128; out: f32 [nrb*128, batch]. All contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 = launched); an
// empty problem launches nothing and returns cudaErrorInvalidValue.
extern "C" int block_ell_spmv(const void* panels, const int* block_col,
                              const float* pv, float* out, int nrb, int s_max,
                              int batch, int mode, void* stream) {
  if (nrb <= 0 || batch <= 0 || s_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nrb, (batch + kTileB - 1) / kTileB);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      block_ell_spmv_kernel<kF32><<<grid, kThreads, 0, st>>>(
          panels, block_col, pv, out, nrb, s_max, batch);
      break;
    case kBF16:
      block_ell_spmv_kernel<kBF16><<<grid, kThreads, 0, st>>>(
          panels, block_col, pv, out, nrb, s_max, batch);
      break;
    case kX3:
      block_ell_spmv_kernel<kX3><<<grid, kThreads, 0, st>>>(
          panels, block_col, pv, out, nrb, s_max, batch);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
