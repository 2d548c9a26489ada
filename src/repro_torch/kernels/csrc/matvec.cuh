// The skinny-GEMM skeleton of common.cuh as one kernel template:
// y (b, n) = x (b, m) @ W (m, n), f32 accumulation, any of f32 / bf16 for
// x, W and y independently. decode_matvec instantiates it once;
// lowrank_gemm twice (x @ U into an f32 scratch, then that @ V).
#pragma once

#include "common.cuh"

namespace rk {
namespace {

// Stage x[row0 : row0 + rows, k0 : k0 + kc] into xs[k][r] as f32, zeros
// past the ragged edges. Neighbouring threads read neighbouring k of one
// row (coalesced); the +1 pad of xs spreads the transposed writes over
// the banks.
template <typename TX, int R>
__device__ __forceinline__ void stage_rows(float (*xs)[R + 1], const TX* __restrict__ x,
                                           int m, int row0, int rows, int k0, int kc) {
  for (int i = threadIdx.y * kCols + threadIdx.x; i < R * kChunk; i += kThreads) {
    const int r = i / kChunk, k = i % kChunk;
    xs[k][r] = (r < rows && k < kc) ? to_f(x[(size_t)(row0 + r) * m + k0 + k]) : 0.f;
  }
}

template <typename TX, typename TW, typename TY, int R>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TY* __restrict__ y,
              int b, int m, int n) {
  __shared__ float xs[kChunk][R + 1];
  __shared__ float red[kSplit][R][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kRowsMax;
  const int rows = min(R, b - row0);

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    const int kc = min(kChunk, m - k0);
    __syncthreads();  // every warp is done with the previous chunk
    stage_rows<TX, R>(xs, x, m, row0, rows, k0, kc);
    __syncthreads();
    if (col < n) {
      const TW* wk = w + (size_t)k0 * n + col;
#pragma unroll 4
      for (int k = warp; k < kc; k += kSplit) {
        const float wv = to_f(wk[(size_t)k * n]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += xs[k][r] * wv;
      }
    }
  }

  // the 8 warps' partial sums, reduced in a fixed order
#pragma unroll
  for (int r = 0; r < R; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  for (int i = warp * kCols + lane; i < R * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int gc = blockIdx.x * kCols + c;
    if (r < rows && gc < n) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kSplit; ++j) s += red[j][r][c];
      y[(size_t)(row0 + r) * n + gc] = from_f<TY>(s);
    }
  }
}

template <typename TX, typename TW, typename TY>
cudaError_t launch_matvec(const void* x, const void* w, void* y, int b, int m, int n,
                          cudaStream_t stream) {
  RK_DISPATCH_ROWS(b, matvec_kernel<TX, TW, TY, R><<<rk_grid(b, n), dim3(kCols, kSplit), 0,
                                                      stream>>>(
                          static_cast<const TX*>(x), static_cast<const TW*>(w),
                          static_cast<TY*>(y), b, m, n));
  return cudaGetLastError();
}

}  // namespace
}  // namespace rk
