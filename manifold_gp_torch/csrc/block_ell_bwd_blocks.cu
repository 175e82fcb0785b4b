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
//   mode 1  bf16: g and the operand slice rounded to bf16 while staged,
//           bf16 x bf16 products (exact in f32) accumulated in f32, the
//           result rounded to bf16 once, on store.
// Padding slots (block_col = 0 over slots the assembly never fills) receive
// g[r] @ pv[0:128]^T like any other slot, as the TPU kernel writes them; no
// consumer reads them.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, ~67 TFLOP/s f32 outside the
// tensor cores). Bytes: nrb*128*S*128*itemsize(out) written, Np*B*4 of g and
// nrb*S*128*B*4 of operand slices read (the slices mostly from L2).
// Operations: 2*nrb*128*S*128*B. At the 262k-node torus (nrb = 2032, S = 22)
// the f32 output alone is 2.93 GB, about 0.87 ms of HBM writes; at B = 48
// the 7.0e10 f32 FLOPs are about 1.05 ms. So the kernel is bound by its
// output write at B = 1 and about evenly by writes and FMAs at B = 48: the
// contraction is short (K = B) and every output byte is written once.
//
// What this simple design does about it: the TPU kernel walks the row
// blocks in order and double-buffers S operand slices; here nothing is
// sequential, so one thread block owns one (r, s) output tile of 128 x 128,
// reads its own block_col[r, s], stages g[r] and the operand slice through
// shared memory in KC-deep chunks of the batch, and its 256 threads each
// keep an 8 x 8 register tile (the forward kernel's inner loop). The batch
// (1, 48, 100, 125 on the training path) is masked at its ragged edge and
// not padded to 128: the chunk loop runs only over the columns that exist,
// so B = 1 costs one FMA per output and the write is what is left. s is the
// fastest grid index, so the S tiles that share g[r] run together and find
// it in L2. Not done yet: vectorised staging loads, cp.async/TMA, mma for
// the bf16 mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;    // rows per row block = column-block width
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kKC = 16;        // batch columns staged per chunk
constexpr int kPad = 4;        // keeps float4 rows aligned, spreads banks

enum OutMode { kOutF32 = 0, kOutBF16 = 1 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
block_ell_bwd_blocks_kernel(const float* __restrict__ g,
                            const int* __restrict__ block_col,
                            const float* __restrict__ pv,
                            void* __restrict__ out, int s_max, int batch) {
  __shared__ __align__(16) float g_s[kKC][kBlock + kPad];  // [k][row i]
  __shared__ __align__(16) float p_s[kKC][kBlock + kPad];  // [k][col j]

  const int s = blockIdx.x % s_max;  // s fastest: the S tiles of one g[r] run together
  const int r = blockIdx.x / s_max;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int col = block_col[(size_t)r * s_max + s];
  const float* g_rows = g + (size_t)r * kBlock * batch;
  const float* p_rows = pv + (size_t)col * kBlock * batch;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < batch; k0 += kKC) {
    const int kc = min(kKC, batch - k0);
    // [128 rows, kc] of g[r] and of the operand slice -> [k][row];
    // consecutive threads read consecutive batch columns of one row.
    for (int e = tid; e < kBlock * kKC; e += kThreads) {
      const int row = e / kKC;
      const int kk = e % kKC;
      if (kk < kc) {
        float gv = g_rows[(size_t)row * batch + k0 + kk];
        float pvv = p_rows[(size_t)row * batch + k0 + kk];
        if (MODE == kOutBF16) {
          gv = round_bf16(gv);
          pvv = round_bf16(pvv);
        }
        g_s[kk][row] = gv;
        p_s[kk][row] = pvv;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise in tx
      const float4 a_lo = *reinterpret_cast<const float4*>(&g_s[kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&g_s[kk][64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&p_s[kk][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&p_s[kk][64 + tx * 4]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // out[r, row, s*128 + c]; each thread stores two runs of 4 columns per row.
  const size_t width = (size_t)s_max * kBlock;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    const size_t base = ((size_t)r * kBlock + row) * width + (size_t)s * kBlock;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t off = base + h * 64 + tx * 4;
      if (MODE == kOutF32) {
        float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                               acc[i][4 * h + 2], acc[i][4 * h + 3]);
        *reinterpret_cast<float4*>(static_cast<float*>(out) + off) = v;
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][4 * h], acc[i][4 * h + 1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][4 * h + 2], acc[i][4 * h + 3]);
        __nv_bfloat162* dst =
            reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + off);
        dst[0] = lo;
        dst[1] = hi;
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). g: f32 [nrb*128, batch];
// block_col: int32 [nrb*S]; pv: f32 [rows, batch] with every block_col id
// < rows/128; out: f32 (mode 0) or bf16 (mode 1) [nrb, 128, S*128]. All
// contiguous. Launches on `stream` and returns cudaGetLastError()
// (0 = launched); an empty problem launches nothing and returns
// cudaErrorInvalidValue.
extern "C" int block_ell_bwd_blocks(const float* g, const int* block_col,
                                    const float* pv, void* out, int nrb,
                                    int s_max, int batch, int out_mode,
                                    void* stream) {
  if (nrb <= 0 || batch <= 0 || s_max <= 0 ||
      (long long)nrb * s_max > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)(nrb * s_max));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_mode) {
    case kOutF32:
      block_ell_bwd_blocks_kernel<kOutF32><<<grid, kThreads, 0, st>>>(
          g, block_col, pv, out, s_max, batch);
      break;
    case kOutBF16:
      block_ell_bwd_blocks_kernel<kOutBF16><<<grid, kThreads, 0, st>>>(
          g, block_col, pv, out, s_max, batch);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
