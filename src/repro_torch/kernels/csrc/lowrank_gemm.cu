// lowrank_gemm — y (b, n) = (x (b, m) @ U (m, r)) @ V (r, n), the paper's
// factored inference GEMM, with the rank intermediate t kept in f32. TX is
// the type of x and y, TW that of U and V: both f32, both bf16, or f32
// activations over bf16 factors (the sLSTM's recurrent GEMM).
//
// Replaces: src/repro/kernels/lowrank_gemm.py:44 lowrank_gemm. On the TPU
// the grid runs in order on one core, so t lives in VMEM scratch carried
// from the m-steps of phase 1 to the n-steps of phase 2 and never reaches
// HBM.
//
// What bounds it on the H100: the bytes of U and V, r*(m + n)*sizeof(TW),
// over 3.35 TB/s (2*b*r*(m + n) operations are far below the compute
// roofline at b <= 16). At the DS2 shapes that is <= 2.6 MB a call, about
// 20 KB an SM: the call is bound by latency (launches, DRAM round trips,
// the split-K hand-offs), not by bandwidth.
//
// What the design does about it: one launch, both phases in one grid.
//   * Work items. Phase-1 items are split-K tiles of t = x @ U (the tile
//     of matvec.cuh, 8 lanes across a row: 64 bf16 columns, k ranges of
//     at least 128 rows, one pass of loads a block); the last block of
//     each t tile sums its ranges in range order into t (matvec.cuh's
//     split-K tail, `last_sums`) and publishes the tile (bar.sync, then
//     thread 0's release-ordered add on a count of published tiles). Phase-2 items are column tiles of y = t @ V,
//     split over r only where a slab cannot hold all of r (not at the DS2
//     shapes: phase 2 then has no partial sums and no second hand-off).
//   * Tickets, not block indices. Each block takes its item from a global
//     ticket (atomicInc at block start), phase-1 items first. A block
//     takes a ticket only once it runs, so a phase-2 block waits only on
//     phase-1 items that running blocks hold, which never wait: no
//     deadlock, whatever the grid size, the order the hardware schedules
//     blocks in, or what else runs on the card.
//   * V in flight while t is computed. A phase-2 block first copies its
//     slab of V (its k range of rows under its columns, <= kSlabBytes)
//     into shared memory with cp.async, then spins (thread 0,
//     ld.acquire) until every t tile is published, stages t through the
//     L2 (16-byte ld.global.cg: L1 is not coherent across SMs) and
//     computes from shared memory. So all of V streams while phase 1
//     streams U. Where no slab fits, or V's rows are not on 16-byte
//     boundaries, the same kernel streams V from global memory after t: a
//     branch uniform over the grid.
//   * Counters reset themselves: the ticket wraps to 0 (atomicInc), the
//     last phase-2 block past its wait zeroes the count of published t
//     tiles, and the split-K tile counters are zeroed by their last block,
//     so the next launch (or a replayed CUDA graph) finds them zero.
// `kernels/lowrank_gemm.lowrank_plan` (Python, tested on the CPU) chooses
// the splits and the slab, all in one wave of resident blocks.
//
// What was tried on the way (H100, DS2 shapes, each block's steps
// stamped with %globaltimer in a scratch copy): 32 lanes and blocks in
// proportion to the bytes of U and V gave 20-40 phase-1 ranges whose last
// blocks summed their partials in several dependent rounds of L2 loads,
// slower than two launches; summing the warps one batch row per pair of
// barriers grew with the batch; summing phase 1's partials in every
// phase-2 block instead of once per tile had all phase-2 blocks read the
// same L2 lines; delaying the slab copies, so that U's loads had the L2
// alone, changed nothing. What is left is a chain of dependent L2 round
// trips: ticket, U, partials, tile counter, sum, publish, t.
#include "matvec.cuh"

namespace {

constexpr int kLanes = 8;           // lanes across a row in both phases (G)
constexpr int kSlabBytes = 32768;   // the largest slab of V a block stages

// blocks an SM the kernel is compiled to fit (registers), by batch rows
// R; RESIDENT in kernels/lowrank_gemm.py. Its grid is ~100 blocks at the
// DS2 shapes, so it trades residency for registers (at 3-4 blocks an SM
// the three inlined tiles spilled).
template <int R>
struct Resident {
  static constexpr int kBlocks = R <= 8 ? 2 : 1;
};

// ints of the counter buffer: the ticket, the published t tiles, the
// phase-2 blocks past their wait, then the phase-1 tile counters and the
// phase-2 ones (one per column tile and batch tile each)
constexpr int kTicket = 0, kTReady = 1, kPast = 2, kTiles = 3;

struct Grid {
  int gx1, split1, kper1;  // phase 1: column tiles of t, k ranges of m, rows a range
  int gx2, split2, kper2;  // phase 2: column tiles of y, k ranges of r, rows a range
  int gz;                  // batch tiles of 16 rows
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// add 1, ordered after every write this thread (and, through the
// block's barrier before it, the block) made
__device__ __forceinline__ void red_release(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;" ::"l"(p) : "memory");
}

template <typename TX, typename TW, int R>
__global__ void __launch_bounds__(rk::mv::kThreads, Resident<R>::kBlocks)
lowrank_kernel(const TX* __restrict__ x, const TW* __restrict__ u, const TW* __restrict__ v,
               float* t, TX* __restrict__ y, float* part1, float* part2, int* count, int b, int m,
               int r, int n, Grid g, bool use_slab, bool aligned_u, bool aligned_v) {
  constexpr int kCols = kLanes * rk::mv::Lane<TW>::kVec;
  __shared__ __align__(16) rk::mv::Smem sm;
  __shared__ int ticket;
  extern __shared__ __align__(16) uint4 slab[];
  const int n1 = g.gx1 * g.split1 * g.gz, n2 = g.gx2 * g.split2 * g.gz;
  if (threadIdx.x == 0)
    ticket = (int)atomicInc(reinterpret_cast<unsigned*>(count + kTicket), n1 + n2 - 1);
  __syncthreads();
  int it = ticket;

  if (it < n1) {  // phase 1: one k range of one tile of t = x @ U
    const int bx = it % g.gx1, by = it / g.gx1 % g.split1, bz = it / g.gx1 / g.split1;
    const int row0 = bz * rk::mv::kBatchTile;
    rk::mv::matvec_block<TX, TW, float, R, kLanes, rk::mv::kStageLoop, false>(
        x, u, nullptr, t, g.split1 > 1 ? part1 : nullptr, b, m, r, r, g.kper1, aligned_u, bx,
        by, bz, sm);
    if (g.split1 == 1 ||
        rk::mv::last_sums<kCols>(part1, count + kTiles + bz * g.gx1 + bx, b, r, g.split1,
                                 bx * kCols, row0, min(R, b - row0), sm.last,
                                 [&](int row, int col, float s) { t[(size_t)row * r + col] = s; })) {
      __syncthreads();  // this block wrote the tile of t: publish it
      if (threadIdx.x == 0) red_release(count + kTReady);
    }
    return;
  }

  // phase 2: one tile of y = t @ V
  it -= n1;
  const int bx = it % g.gx2, by = it / g.gx2 % g.split2, bz = it / g.gx2 / g.split2;
  const int row0 = bz * rk::mv::kBatchTile;
  if (use_slab) {
    const int k0 = by * g.kper2;
    const int col0 = bx * kCols + threadIdx.x % kLanes * rk::mv::Lane<TW>::kVec;
    if (col0 < n) rk::mv::copy_slab<TW, kLanes>(slab, v, n, k0, min(r, k0 + g.kper2) - k0, col0);
  }
  unsigned past = 0;  // phase-2 blocks past the wait before this one
  if (threadIdx.x == 0) {
    while (ld_acquire(count + kTReady) < g.gx1 * g.gz) __nanosleep(32);
    past = atomicInc(reinterpret_cast<unsigned*>(count + kPast), n2 - 1);  // read at the end
  }
  __syncthreads();
  float* p2 = g.split2 > 1 ? part2 : nullptr;
  if (use_slab) {
    rk::mv::wait_slab();
    rk::mv::matvec_block<float, TW, TX, R, kLanes, rk::mv::kStageFresh, true>(
        t, v, slab, y, p2, b, r, n, n, g.kper2, aligned_v, bx, by, bz, sm);
  } else {
    rk::mv::matvec_block<float, TW, TX, R, kLanes, rk::mv::kStageFresh, false>(
        t, v, nullptr, y, p2, b, r, n, n, g.kper2, aligned_v, bx, by, bz, sm);
  }
  if (g.split2 > 1)
    rk::mv::last_sums<kCols>(part2, count + kTiles + g.gz * g.gx1 + bz * g.gx2 + bx, b, n,
                             g.split2, bx * kCols, row0, min(R, b - row0), sm.last,
                             [&](int row, int col, float s) {
                               y[(size_t)row * n + col] = rk::from_f<TX>(s);
                             });
  // the last phase-2 block past the wait: nobody reads the count of
  // published t tiles again in this launch
  if (threadIdx.x == 0 && past == (unsigned)(n2 - 1)) count[kTReady] = 0;
}

bool covers(int k, int split, int kper) {
  return k > 0 && kper > 0 && split > 0 && (long long)split * kper >= k &&
         (long long)(split - 1) * kper < k;
}

// work: t (b * r floats), then phase 1's partial sums (split1 * b * r,
// when split1 > 1), then phase 2's (split2 * b * n, when split2 > 1).
// count: 3 + gz * (gx1 + gx2) zeroed ints (left zeroed).
template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* u, const void* v, void* y, float* work,
                   int* count, int b, int m, int r, int n, int split1, int kper1, int split2,
                   int kper2, int slab, cudaStream_t s) {
  constexpr int V = rk::mv::Lane<TW>::kVec, kCols = kLanes * V;
  if (b <= 0 || n <= 0 || !covers(m, split1, kper1) || !covers(r, split2, kper2) ||
      work == nullptr || count == nullptr)
    return cudaErrorInvalidValue;
  const Grid g{(r + kCols - 1) / kCols, split1, kper1, (n + kCols - 1) / kCols, split2, kper2,
               (b + rk::mv::kBatchTile - 1) / rk::mv::kBatchTile};
  const long long blocks =
      (long long)g.gz * ((long long)g.gx1 * split1 + (long long)g.gx2 * split2);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const bool aligned_u = r % V == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  const bool aligned_v = n % V == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  float* t = work;
  float* part1 = t + (size_t)b * r;
  float* part2 = part1 + (split1 > 1 ? (size_t)split1 * b * r : 0);
  const int slab_bytes = kper2 * kCols * (int)sizeof(TW);
  bool use_slab = false;
  RK_DISPATCH_ROWS(b, {
    use_slab = slab != 0 && aligned_v && slab_bytes <= kSlabBytes &&
               kper2 <= rk::mv::kXsFloats / R;  // one chunk of staged t a range
    const auto kernel = lowrank_kernel<TX, TW, R>;
    if (use_slab) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabBytes);
      if (err != cudaSuccess) return err;
    }
    kernel<<<(unsigned)blocks, rk::mv::kThreads, use_slab ? slab_bytes : 0, s>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(u), static_cast<const TW*>(v), t,
        static_cast<TX*>(y), part1, part2, count, b, m, r, n, g, use_slab, aligned_u, aligned_v);
  });
  return cudaGetLastError();
}

}  // namespace

extern "C" int rk_lowrank_gemm(const void* x, const void* u, const void* v, void* y, void* work,
                               void* count, int b, int m, int r, int n, int split1, int kper1,
                               int split2, int kper2, int slab, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  int* c = static_cast<int*>(count);
  if (dtype == rk::kF32)
    return launch<float, float>(x, u, v, y, w, c, b, m, r, n, split1, kper1, split2, kper2, slab,
                                s);
  if (dtype == rk::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, u, v, y, w, c, b, m, r, n, split1, kper1,
                                                split2, kper2, slab, s);
  if (dtype == rk::kF32BF16)
    return launch<float, __nv_bfloat16>(x, u, v, y, w, c, b, m, r, n, split1, kper1, split2,
                                        kper2, slab, s);
  return cudaErrorInvalidValue;
}
