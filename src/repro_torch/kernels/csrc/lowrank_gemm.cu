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
// of the TPU becomes two calls of the skinny-GEMM template of matvec.cuh
// on one stream: phase 1 writes t = x @ U (b x r, f32) into a scratch
// tensor the wrapper allocates, phase 2 reads it back for t @ V. Each
// phase is tiled and split along its own k axis as
// `kernels/decode_matvec.plan` chooses (lanes1/split1/kper1 over m,
// lanes2/split2/kper2 over r); the phases share one partial-sum workspace
// `part` and one set of tile counters `count` (zeroed, and left zeroed),
// sized for the larger, since the stream runs them one after the other.
// t is at most 16 x 1280 x 4 bytes = 80 KB
// per 16 rows, so it goes through the L2; the stream order is the barrier
// between the phases. Not done: one fused launch (t re-derived per block,
// or a cooperative grid).
#include "matvec.cuh"

namespace {

// plan: {lanes, split, kper} of phase 1 (x @ U), then of phase 2 (t @ V)
template <typename T>
cudaError_t launch(const void* x, const void* u, const void* v, void* t, void* y, float* part,
                   int* count, int b, int m, int r, int n, const int* plan, cudaStream_t s) {
  cudaError_t err = rk::launch_matvec<T, T, float>(x, u, t, part, count, b, m, r, plan[0],
                                                   plan[1], plan[2], s);
  if (err != cudaSuccess) return err;
  return rk::launch_matvec<float, T, T>(t, v, y, part, count, b, r, n, plan[3], plan[4],
                                        plan[5], s);
}

}  // namespace

extern "C" int rk_lowrank_gemm(const void* x, const void* u, const void* v, void* t, void* y,
                               void* part, void* count, int b, int m, int r, int n, int lanes1,
                               int split1, int kper1, int lanes2, int split2, int kper2,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(count);
  const int plan[6] = {lanes1, split1, kper1, lanes2, split2, kper2};
  if (dtype == rk::kF32) return launch<float>(x, u, v, t, y, p, c, b, m, r, n, plan, s);
  if (dtype == rk::kBF16) return launch<__nv_bfloat16>(x, u, v, t, y, p, c, b, m, r, n, plan, s);
  return cudaErrorInvalidValue;
}
