// decode_matvec — y (b, n) = x (b, m) @ W (m, n) at serving batch, f32
// accumulation, output in x's type: x, W and y all f32, all bf16, or f32 x
// and y over a bf16 W (x staged as f32 as always, W streamed as bf16).
//
// Replaces: src/repro/kernels/decode_matvec.py:38 decode_matvec, the
// Pallas kernel that keeps x resident in VMEM and streams W tile by tile.
//
// What bounds it on the H100: the bytes of W, m*n*sizeof(T) over
// 3.35 TB/s (a llama3-8b decode step streams 15 GB of bf16 weights through
// 225 of these launches; a DS2 frame step ~19 MB, which fits the 50 MB L2,
// so there launch latency dominates).
//
// The design (the template of matvec.cuh, whose note has the details):
// 16-byte no-L1-allocate loads, 4 in flight a lane, 8 warps a block
// owning 64-256 bf16 columns; split-K across blocks, chosen by `plan()` in
// kernels/decode_matvec.py so the grid fills the SMs' resident blocks once
// (up to 48 KB of loads in flight an SM); f32 partial sums in a
// wrapper-allocated workspace, summed in a fixed order by the last block
// of each column tile (an int counter a tile, which that block resets).
// The plan's `lanes`, `split` and `kper` (rows of one k range) are passed
// in, with `part` (split * b * n floats) and `count` (one zeroed int a
// column tile and batch tile).
// Not done: TMA-staged W, hiding the one wave's prologue and epilogue.
#include "matvec.cuh"

extern "C" int rk_decode_matvec(const void* x, const void* w, void* y, void* part,
                                void* count, int b, int m, int n, int lanes, int split,
                                int kper, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(count);
  if (dtype == rk::kF32)
    return rk::launch_matvec<float, float, float>(x, w, y, p, c, b, m, n, lanes, split, kper,
                                                  s);
  if (dtype == rk::kBF16)
    return rk::launch_matvec<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        x, w, y, p, c, b, m, n, lanes, split, kper, s);
  if (dtype == rk::kF32BF16)
    return rk::launch_matvec<float, __nv_bfloat16, float>(x, w, y, p, c, b, m, n, lanes, split,
                                                          kper, s);
  return cudaErrorInvalidValue;
}
