// lowrank_gemm — y (b, n) = (x (b, m) @ U (m, r)) @ V (r, n), the paper's
// factored inference GEMM, with the rank intermediate t kept in f32.
//
// Replaces: src/repro/kernels/lowrank_gemm.py:44 lowrank_gemm. On the TPU
// the grid runs in order on one core, so t lives in VMEM scratch carried
// from the m-steps of phase 1 to the n-steps of phase 2 and never reaches
// HBM.
//
// What bounds it on the H100: the bytes of U and V, r*(m + n)*sizeof(T),
// over 3.35 TB/s (2*b*r*(m + n) operations are far below the compute
// roofline at b <= 16).
//
// What the design does about it: Hopper blocks run in parallel with no
// order and carry nothing from one to the next, so the single fused grid
// of the TPU becomes two launches of the matvec skeleton on one stream:
// phase 1 writes t = x @ U (b x r, f32) into a scratch tensor the wrapper
// allocates, phase 2 reads it back for t @ V. t is at most 16 x 1280 x 4
// bytes = 80 KB per 16 rows, so it goes through the L2 and not through
// registers as on the TPU; the stream order is the barrier between the
// phases. U and V are each read once, coalesced. A fused version (one
// cooperative launch, or t re-derived per block) is for a later PR.
#include "matvec.cuh"

namespace {

template <typename T>
cudaError_t launch(const void* x, const void* u, const void* v, void* t, void* y, int b,
                   int m, int r, int n, cudaStream_t s) {
  cudaError_t err = rk::launch_matvec<T, T, float>(x, u, t, b, m, r, s);
  if (err != cudaSuccess) return err;
  return rk::launch_matvec<float, T, T>(t, v, y, b, r, n, s);
}

}  // namespace

extern "C" int rk_lowrank_gemm(const void* x, const void* u, const void* v, void* t, void* y,
                               int b, int m, int r, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rk::kF32) return launch<float>(x, u, v, t, y, b, m, r, n, s);
  if (dtype == rk::kBF16) return launch<__nv_bfloat16>(x, u, v, t, y, b, m, r, n, s);
  return cudaErrorInvalidValue;
}
