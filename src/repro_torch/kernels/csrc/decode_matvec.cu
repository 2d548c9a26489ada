// decode_matvec — y (b, n) = x (b, m) @ W (m, n) at serving batch, f32
// accumulation, output in x's type (f32 or bf16).
//
// Replaces: src/repro/kernels/decode_matvec.py:38 decode_matvec, the
// Pallas kernel that keeps x resident in VMEM and streams W tile by tile.
//
// What bounds it on the H100: the bytes of W. At b <= 16 the kernel does
// 2*b operations per weight element read (<= 16 per bf16 byte), far below
// the ~295 operations per byte where the tensor cores would become the
// limit, so its least time is m*n*sizeof(T) / 3.35 TB/s (a DS2 frame step
// touches ~39 MB of bf16 weights, which also fits the 50 MB L2).
//
// What the design does about it: W is read exactly once, coalesced (a
// warp reads 32 neighbouring columns of a row); x is staged in shared
// memory and read as broadcasts; the 8 warps of a block split m so more
// loads are in flight per column. What it does not do yet: with 32
// columns per block, n = 1536..3840 gives 48..120 blocks for 132 SMs, and
// the loads are 2-byte scalars; vector loads, split-K across blocks and
// TMA are for a later version.
#include "matvec.cuh"

extern "C" int rk_decode_matvec(const void* x, const void* w, void* y, int b, int m, int n,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rk::kF32) return rk::launch_matvec<float, float, float>(x, w, y, b, m, n, s);
  if (dtype == rk::kBF16)
    return rk::launch_matvec<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(x, w, y, b, m, n, s);
  return cudaErrorInvalidValue;
}
