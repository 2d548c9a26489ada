// int8_gemm — w8a8 GEMM with fused dequantization:
//   y (b, n) f32 = (x_q (b, m) s8 @ w_q (m, n) s8, accumulated in s32)
//                  * x_scale[b] * w_scale[n]
// The epilogue is (float(acc) * x_scale) * w_scale, in that order and with
// no fused multiply-add, so y equals the plain version bit for bit.
//
// Replaces: src/repro/kernels/int8_gemm.py:41 int8_gemm (a PTQ'd leaf
// calls it once, a factored PTQ'd leaf twice: src/repro/quant/leaf.py).
//
// What bounds it on the H100: the bytes of w_q, m*n bytes, over
// 3.35 TB/s — half the bytes of the bf16 weight it was quantized from.
//
// What the design does about it: the matvec skeleton of common.cuh with
// integer arithmetic — a warp reads 32 neighbouring bytes of a row of w_q
// (one 32-byte sector), x_q is staged in shared memory as int, each
// thread keeps R s32 accumulators, and the 8 warps' partial sums are
// added in shared memory (integer sums: exact in any order). Packed
// 4-byte loads with __dp4a and the tensor cores' s8 path are for later.
#include "common.cuh"

namespace {

using rk::kChunk;
using rk::kCols;
using rk::kRowsMax;
using rk::kSplit;
using rk::kThreads;

template <int R>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                 float* __restrict__ y, int b, int m, int n) {
  __shared__ int xs[kChunk][R + 1];
  __shared__ int red[kSplit][R][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * kCols + lane;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kRowsMax;
  const int rows = min(R, b - row0);

  int acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    const int kc = min(kChunk, m - k0);
    __syncthreads();
    for (int i = tid; i < R * kChunk; i += kThreads) {
      const int r = i / kChunk, k = i % kChunk;
      xs[k][r] = (r < rows && k < kc) ? static_cast<int>(x[(size_t)(row0 + r) * m + k0 + k]) : 0;
    }
    __syncthreads();
    if (col < n) {
      const int8_t* wk = w + (size_t)k0 * n + col;
#pragma unroll 4
      for (int k = warp; k < kc; k += kSplit) {
        const int wv = wk[(size_t)k * n];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += xs[k][r] * wv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  for (int i = tid; i < R * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int gc = blockIdx.x * kCols + c;
    if (r < rows && gc < n) {
      int s = 0;
#pragma unroll
      for (int j = 0; j < kSplit; ++j) s += red[j][r][c];
      y[(size_t)(row0 + r) * n + gc] =
          __fmul_rn(__fmul_rn(__int2float_rn(s), x_scale[row0 + r]), w_scale[gc]);
    }
  }
}

}  // namespace

extern "C" int rk_int8_gemm(const void* x_q, const void* w_q, const void* x_scale,
                            const void* w_scale, void* y, int b, int m, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RK_DISPATCH_ROWS(b, int8_gemm_kernel<R><<<rk_grid(b, n), dim3(kCols, kSplit), 0, s>>>(
                          static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(w_q),
                          static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
                          static_cast<float*>(y), b, m, n));
  return cudaGetLastError();
}
