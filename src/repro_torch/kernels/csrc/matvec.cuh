// The skinny-GEMM kernel template: y (b, n) = x (b, m) @ W (m, n), W
// row-major, f32 accumulation, any of f32 / bf16 for x, W and y
// independently. decode_matvec instantiates it once; lowrank_gemm twice
// (x @ U into an f32 scratch, then that @ V).
//
// What bounds it on the H100: the bytes of W. At b <= 16 it does 2*b
// operations per weight element (<= 16 per bf16 byte), far below the ~295
// operations per byte where the tensor cores would become the limit. At
// 3.35 TB/s and 1-2 us of loaded DRAM latency, Little's law asks for
// 25-50 KB of loads in flight on each of the 132 SMs.
//
// The design:
//   * Loads: each lane owns 16 bytes of a row of W (8 bf16 or 4 f32
//     columns) and reads them with one ld.global.nc.L1::no_allocate.v4
//     (each byte of W is used once: no L1 allocation). G lanes side by
//     side (G = 32, 16 or 8) cover G x 16 bytes of a row, the columns the
//     block owns; the 32 / G lane groups of a warp and the 8 warps take
//     different rows (256 / G row slots). Each lane issues kUnroll = 4
//     independent loads before it uses any: 16 KB in flight a block, and
//     3 blocks resident an SM at b <= 4 (register-bound; 4 at b <= 2, 2 at
//     b <= 8, 1 at b <= 16), so up to 48 KB in flight an SM. The first
//     loads go out before x is staged, so their latency hides the staging.
//   * Split-K across blocks: blockIdx.y takes k range
//     [y * kper, min(m, (y + 1) * kper)). `kernels/decode_matvec.plan`
//     (Python, testable on the CPU) chooses G and the split so that the
//     grid fills the SMs' resident blocks once (one wave, no tail). With one
//     range a block writes y; with several, each writes its f32 partial sums
//     to part[y][b][n] (a workspace the wrapper allocates), counts itself in
//     an int counter of its (column tile, batch tile), and the last block
//     of the tile sums the ranges in order 0, 1, ... and resets the
//     counter: one launch, no floating-point atomics, the same result run
//     to run whichever block comes last. (A thread block cluster summing
//     the partials through distributed shared memory was measured too: its
//     8-block limit and co-scheduling cost more than it saved.)
//   * x: the block stages its k range of x (all its batch rows) in shared
//     memory as f32 [k][R], at most kXsFloats at a time (a longer range is
//     staged in chunks), and every lane reads x[k][0..R) as broadcasts.
//   * R, the batch rows a block holds, is the batch rounded up to a power
//     of two (<= 16, a template parameter); blockIdx.z walks batches above
//     16. Ragged edges are masked: a W whose rows are not 16-byte aligned
//     (n not a multiple of 8 in bf16, of 4 in f32) is read with scalar
//     loads into the same registers, by a branch of the same kernel that
//     takes one way for the whole grid.
// What it does not do: its one wave of blocks stages x and sums the
// split-K partials all at the same time, with no other block streaming
// W meanwhile; hiding that prologue and epilogue (blocks of uneven phase,
// a persistent grid) is what remains against torch.matmul. Nor TMA
// staging of W, or lowrank_gemm's two phases in one launch.
#pragma once

#include "common.cuh"

namespace rk {
namespace {
namespace mv {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;          // rows of W a lane has in flight
constexpr int kXsFloats = 4096;     // x staged at a time: rows * R <= 4096 floats (16 KB)
constexpr int kBatchTile = 16;      // batch rows a block holds at most

template <typename TW>
struct Lane {
  static constexpr int kVec = 16 / (int)sizeof(TW);  // columns a lane owns
};

// blocks an SM the kernel is compiled to fit (registers), by batch rows
// R; RESIDENT in kernels/decode_matvec.py
template <int R>
struct Resident {
  static constexpr int kBlocks = R <= 2 ? 4 : R <= 4 ? 3 : R <= 8 ? 2 : 1;
};

// 16 bytes of W through the read-only path, not allocated in L1
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The lane's kVec columns of one row as raw bits (the layout of one
// 16-byte vector) by scalar loads, zero past n: a row not on a 16-byte
// boundary.
template <typename TW>
__device__ __forceinline__ uint4 load_ragged(const TW* p, int col0, int n) {
  constexpr int V = Lane<TW>::kVec;
  uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < V; ++c) {
    if (col0 + c < n) {
      if constexpr (sizeof(TW) == 4) {
        u[c] = __float_as_uint(__ldg(reinterpret_cast<const float*>(p) + c));
      } else {
        const uint32_t bits = __bfloat16_as_ushort(__ldg(p + c));
        u[c / 2] |= bits << (16 * (c % 2));
      }
    }
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// bf16 -> f32 is exact: the bf16 bits are the f32's high half
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Issue the loads of rows kb, kb + slots, ... (kUnroll of them) of the
// lane's columns; rows at or past kc read as zero. `aligned` (every row
// on a 16-byte boundary) is the same for the whole grid: one vector load
// a row, else scalars.
template <typename TW>
__device__ __forceinline__ void load_rows(uint4 (&raw)[kUnroll], const TW* wp, int kb,
                                          int slots, int kc, int col0, int n, bool aligned) {
  if (aligned) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kb + u * slots;
      raw[u] = k < kc ? ld_stream(wp + (size_t)k * n) : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kb + u * slots;
      raw[u] = k < kc ? load_ragged(wp + (size_t)k * n, col0, n) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Stage x[row0 + r][k0 + k] for r < R, k < kc into xs[k * R + r] as f32,
// zero for rows past `rows`; neighbouring threads read neighbouring k.
template <typename TX, int R>
__device__ __forceinline__ void stage_x(float* xs, const TX* __restrict__ x, int m, int row0,
                                        int rows, int k0, int kc) {
  for (int i = threadIdx.x; i < R * kc; i += kThreads) {
    const int r = i / kc, k = i - r * kc;
    xs[k * R + r] = r < rows ? to_f(x[(size_t)(row0 + r) * m + k0 + k]) : 0.f;
  }
}

// y[row0 + r][col] = the sum over k ranges j = 0, 1, ... of
// part[j][row0 + r][col], in that order, for rows r < rows and the
// block's columns [col_begin, col_begin + cols); 8 loads in flight a
// thread.
template <typename TY>
__device__ __forceinline__ void sum_ranges(const float* __restrict__ part, TY* __restrict__ y,
                                           int b, int n, int split, int row0, int rows,
                                           int col_begin, int cols) {
  const size_t stride = (size_t)b * n;
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, col = col_begin + i % cols;
    if (col >= n) continue;
    const float* src = part + (size_t)(row0 + r) * n + col;
    float s = 0.f;
    int j = 0;
    for (; j + 8 <= split; j += 8) {
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = __ldcg(src + (size_t)(j + t) * stride);
#pragma unroll
      for (int t = 0; t < 8; ++t) s += v[t];
    }
    for (; j < split; ++j) s += __ldcg(src + (size_t)j * stride);
    y[(size_t)(row0 + r) * n + col] = from_f<TY>(s);
  }
}

// G lanes side by side cover G x kVec columns of a row (a block owns
// those columns); the 32 / G lane groups of a warp and the 8 warps take
// different rows: 256 / G row slots a block.
template <typename TX, typename TW, typename TY, int R, int G>
__global__ void __launch_bounds__(kThreads, Resident<R>::kBlocks)
matvec_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TY* __restrict__ y,
              float* __restrict__ part, int* __restrict__ count, int b, int m, int n, int kper,
              bool aligned) {
  constexpr int V = Lane<TW>::kVec, kCols = G * V, kSlots = kThreads / G;
  constexpr int kXsRows = kXsFloats / R;  // rows of x staged at a time
  __shared__ __align__(16) float xs[kXsFloats];       // [k][R]
  __shared__ __align__(16) float red[kWarps][kCols];  // the warps' sums of one batch row
  __shared__ int last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int slot = warp * (32 / G) + lane / G;  // this lane's first row
  const int col0 = blockIdx.x * kCols + (lane % G) * V;
  const int row0 = blockIdx.z * kBatchTile, rows = min(R, b - row0);
  const int k0 = blockIdx.y * kper, kend = min(m, k0 + kper);
  const bool live = col0 < n;

  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[r][c] = 0.f;

  for (int kx = k0; kx < kend; kx += kXsRows) {  // one chunk of staged x
    const int kc = min(kXsRows, kend - kx);
    const TW* wp = w + (size_t)kx * n + col0;
    uint4 raw[kUnroll];
    // the lane's first rows of W are in flight while x is staged
    if (live) load_rows(raw, wp, slot, kSlots, kc, col0, n, aligned);
    if (kx > k0) __syncthreads();  // every warp is done with the previous chunk
    stage_x<TX, R>(xs, x, m, row0, rows, kx, kc);
    __syncthreads();
    if (live) {
      for (int kb = slot; kb < kc; kb += kSlots * kUnroll) {
        if (kb != slot) load_rows(raw, wp, kb, kSlots, kc, col0, n, aligned);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = kb + u * kSlots;
          if (k < kc) {
            float wf[V];
            unpack(raw[u], wf);
            const float* xr = xs + k * R;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float xv = xr[r];
#pragma unroll
              for (int c = 0; c < V; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
            }
          }
        }
      }
    }
  }

  // The sums of one column: first over the warp's 32 / G lane groups (a
  // fixed shuffle tree), then over the 8 warps in warp order; into y (one
  // k range) or into this range's slice of the partial sums.
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int off = G; off < 32; off *= 2)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {  // uniform across the block
      if (lane < G) {
#pragma unroll
        for (int c = 0; c < V; ++c) red[warp][lane * V + c] = acc[r][c];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kCols; i += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kWarps; ++j) s += red[j][i];
        const int col = blockIdx.x * kCols + i;
        if (col < n) {
          if (part != nullptr)
            part[((size_t)blockIdx.y * b + row0 + r) * n + col] = s;
          else
            y[(size_t)(row0 + r) * n + col] = from_f<TY>(s);
        }
      }
      __syncthreads();
    }
  }
  if (part == nullptr) return;

  // Split k: the last block of this (column tile, batch tile) to finish
  // sums the ranges' partials in range order (the same order whichever
  // block is last) and resets the tile's counter for the next launch.
  __threadfence();  // this block's partials are visible before it counts
  __syncthreads();
  if (threadIdx.x == 0) {
    int* c = count + blockIdx.z * gridDim.x + blockIdx.x;
    last = atomicAdd(c, 1) == (int)gridDim.y - 1;
    if (last) *c = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_ranges<TY>(part, y, b, n, gridDim.y, row0, rows, blockIdx.x * kCols, kCols);
}

}  // namespace mv

// one launch of the kernel with G lanes across a row
#define RK_MATVEC_LAUNCH(G)                                                              \
  mv::matvec_kernel<TX, TW, TY, R, G><<<grid, mv::kThreads, 0, stream>>>(               \
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TY*>(y), p, c, b, \
      m, n, kper, aligned)

// y = x @ W in `split` k ranges of `kper` rows, G = `lanes` lanes across a
// row (the plan of kernels/decode_matvec.py). When split > 1, `part` holds
// split * b * n floats and `count` one int for each (column tile, batch
// tile), all zero (the kernel leaves them zero again); neither is read
// otherwise.
template <typename TX, typename TW, typename TY>
cudaError_t launch_matvec(const void* x, const void* w, void* y, float* part, int* count,
                          int b, int m, int n, int lanes, int split, int kper,
                          cudaStream_t stream) {
  constexpr int V = mv::Lane<TW>::kVec;
  if (b <= 0 || m <= 0 || n <= 0 || kper <= 0 || split <= 0 || split > 65535 ||
      (lanes != 8 && lanes != 16 && lanes != 32) || (long long)split * kper < m ||
      (long long)(split - 1) * kper >= m ||
      (split > 1 && (part == nullptr || count == nullptr)))
    return cudaErrorInvalidValue;
  const bool aligned = n % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n + lanes * V - 1) / (lanes * V), split,
                  (b + mv::kBatchTile - 1) / mv::kBatchTile);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  float* p = split > 1 ? part : nullptr;
  int* c = split > 1 ? count : nullptr;
  RK_DISPATCH_ROWS(b, {
    if (lanes == 32) RK_MATVEC_LAUNCH(32);
    else if (lanes == 16) RK_MATVEC_LAUNCH(16);
    else RK_MATVEC_LAUNCH(8);
  });
  return cudaGetLastError();
}

#undef RK_MATVEC_LAUNCH

}  // namespace
}  // namespace rk
