// Shared pieces of the skinny-GEMM kernels (sm_90a): the dtype codes and
// conversions every kernel uses, and the first skeleton, which gru_cell
// and int8_gemm still run (decode_matvec and lowrank_gemm run the
// split-K template of matvec.cuh).
//
// Each of those kernels multiplies a few activation rows (the serving
// batch, b <= 16 per block) by a weight matrix W (m, n) stored row-major,
// and is bound by the bytes of W it streams. The skeleton:
//
//   * a block owns kCols = 32 neighbouring output columns, one per lane,
//     so a warp reads 32 neighbouring elements of one row of W: coalesced;
//   * the block's kSplit = 8 warps split the reduction axis m between
//     them (warp j takes rows j, j + 8, ...), which multiplies the blocks'
//     loads in flight by 8 without atomics, and reduces the 8 partial sums
//     through shared memory in a fixed order (deterministic);
//   * the activation rows are staged in shared memory kChunk rows of m at
//     a time, read back as broadcasts (all lanes of a warp read one value);
//   * each thread keeps R <= 16 accumulators in registers, R the batch
//     rounded up to a power of two (a template parameter: a batch-1 step
//     does not pay for 16 rows); blockIdx.y walks batches above 16.
//
// Ragged edges (n not a multiple of 32, m not a multiple of kChunk, any b)
// are masked in the kernels: no padding is asked of the caller.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rk {

constexpr int kCols = 32;
constexpr int kSplit = 8;
constexpr int kThreads = kCols * kSplit;
constexpr int kRowsMax = 16;
constexpr int kChunk = 64;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

}  // namespace
}  // namespace rk

// Instantiate the statement with a compile-time R: the batch rows a block holds,
// rounded up to a power of two, capped at 16.
#define RK_DISPATCH_ROWS(b, ...)                             \
  do {                                                       \
    if ((b) <= 1) { constexpr int R = 1; __VA_ARGS__; }      \
    else if ((b) <= 2) { constexpr int R = 2; __VA_ARGS__; } \
    else if ((b) <= 4) { constexpr int R = 4; __VA_ARGS__; } \
    else if ((b) <= 8) { constexpr int R = 8; __VA_ARGS__; } \
    else { constexpr int R = 16; __VA_ARGS__; }              \
  } while (0)

inline dim3 rk_grid(int b, int n) {
  return dim3((n + rk::kCols - 1) / rk::kCols,
              (b + rk::kRowsMax - 1) / rk::kRowsMax);
}
