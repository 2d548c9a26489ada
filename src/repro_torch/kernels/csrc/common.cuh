// Shared pieces of every kernel of this directory (sm_90a): the dtype
// codes the launchers take, the conversions between them and f32, and
// RK_DISPATCH_ROWS, which instantiates a skinny GEMM's kernel for the
// batch rows a block holds. The skinny GEMMs' tile, warp sums and split-K
// tail are in matvec.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rk {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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
