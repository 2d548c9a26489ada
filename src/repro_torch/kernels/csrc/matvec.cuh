// The skinny-GEMM kernel template: y (b, n) = x (b, m) @ W (m, n), W
// row-major, f32 accumulation, any of f32 / bf16 for x, W and y
// independently. One tile of it is `matvec_block`: decode_matvec's kernel
// runs one a block; lowrank_gemm's fused kernel runs both of its phases
// (x @ U into an f32 t, then t @ V from a slab of V in shared memory) as
// tiles of one grid; gru_cell's kernel runs one gate's columns of h @ U a
// block (W's rows `ld` apart, wider than the tile's n columns). Its warp
// sums (`block_sums`) and split-K tail (`last_sums`, built of
// `arrive_last` and `range_sums`, which gru_cell's gate tail uses
// directly) are int8_gemm's too, on s32.
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
//     counter (`last_sums`): one launch, no floating-point atomics, the
//     same result run to run whichever block comes last. (A thread block
//     cluster summing the partials through distributed shared memory was
//     measured too: its 8-block limit and co-scheduling cost more than it
//     saved.)
//   * The block's sums over its 8 warps go through shared memory P batch
//     rows per pair of barriers (`block_sums`; xs is free once the block
//     has computed), not one row per pair, whose barriers grew with the
//     batch.
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
// staging of W.
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
// lane's columns (rows ld elements apart, columns below n); rows at or
// past kc read as zero. `aligned` (every row on a 16-byte boundary) is
// the same for the whole grid: one vector load a row, else scalars.
template <typename TW>
__device__ __forceinline__ void load_rows(uint4 (&raw)[kUnroll], const TW* wp, int kb,
                                          int slots, int kc, int col0, int n, int ld,
                                          bool aligned) {
  if (aligned) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kb + u * slots;
      raw[u] = k < kc ? ld_stream(wp + (size_t)k * ld) : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kb + u * slots;
      raw[u] = k < kc ? load_ragged(wp + (size_t)k * ld, col0, n) : make_uint4(0u, 0u, 0u, 0u);
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

// Stage the same x, f32, written by other blocks of this launch: read
// through the L2 (ld.global.cg; L1 is not coherent across SMs), four
// neighbouring k a thread (one 16-byte load) where the rows allow.
template <int R>
__device__ __forceinline__ void stage_x_fresh(float* xs, const float* x, int m, int row0,
                                              int rows, int k0, int kc) {
  if (m % 4 == 0 && k0 % 4 == 0 && kc % 4 == 0) {  // uniform
    const int groups = kc / 4;
    for (int i = threadIdx.x; i < R * groups; i += kThreads) {
      const int r = i / groups, k = 4 * (i - r * groups);
      const float4 v =
          r < rows ? __ldcg(reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * m + k0 + k))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      xs[k * R + r] = v.x;
      xs[(k + 1) * R + r] = v.y;
      xs[(k + 2) * R + r] = v.z;
      xs[(k + 3) * R + r] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < R * kc; i += kThreads) {
      const int r = i / kc, k = i - r * kc;
      xs[k * R + r] = r < rows ? __ldcg(x + (size_t)(row0 + r) * m + k0 + k) : 0.f;
    }
  }
}

// How matvec_block stages its chunk of x: through the ordinary path, or
// through the L2 (x written earlier in the same launch).
enum Stage { kStageLoop, kStageFresh };

// The row slot of this thread (its first row of a k range) when G lanes
// lie side by side across a row: 256 / G slots a block.
template <int G>
__device__ __forceinline__ int row_slot() {
  return (threadIdx.x / 32) * (32 / G) + (threadIdx.x % 32) / G;
}

// A slab: the rows [k0, k0 + kc) of W under a block's G x 16 bytes of
// columns, in shared memory as [k][G] 16-byte vectors. Each thread copies
// (cp.async, 16 bytes, L2 only) exactly the vectors it later reads, so
// its own cp.async.wait_all makes them visible to it: no barrier. W's rows
// must lie on 16-byte boundaries.
template <typename TW, int G>
__device__ __forceinline__ void copy_slab(uint4* slab, const TW* __restrict__ w, int n, int k0,
                                          int kc, int col0) {
  constexpr int kSlots = kThreads / G;
  for (int k = row_slot<G>(); k < kc; k += kSlots) {
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(slab + k * G + threadIdx.x % G));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(w + (size_t)(k0 + k) * n + col0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_slab() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// The lane's vectors of slab rows kb, kb + slots, ... (kUnroll of them);
// rows at or past kc read as zero.
template <int G>
__device__ __forceinline__ void slab_rows(uint4 (&raw)[kUnroll], const uint4* slab, int kb,
                                          int slots, int kc) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int k = kb + u * slots;
    raw[u] = k < kc ? slab[k * G + threadIdx.x % G] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Shared memory of one block: staged x (also the warps' sums once the
// block has computed), and the last-block flag.
struct Smem {
  float xs[kXsFloats];  // [k][R], then block_sums' [warp][P][columns]
  int last;
};

// The block's sums of its threads' accumulators (acc[r][c]: batch row r,
// the lane's V columns; TA = f32 or s32), one a (batch row, column of the
// block's G * V): first over the warp's 32 / G lane groups (a fixed
// shuffle tree), then over the 8 warps in warp order, P batch rows per
// pair of barriers through `red` ([warp][P][G * V] in shared memory; the
// caller syncs before it reuses it). kOwnRed: red is the sums' own, else
// it is memory other warps may still read (staged x) and the first pass
// syncs first too. emit(r, i, s) takes batch row r < rows and column i
// of the block.
template <int G, int P, bool kOwnRed, typename TA, int R, int V, typename Emit>
__device__ __forceinline__ void block_sums(TA (&acc)[R][V], TA* red, int rows, Emit emit) {
  constexpr int kCols = G * V;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int off = G; off < 32; off *= 2)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
#pragma unroll
  for (int r0 = 0; r0 < R; r0 += P) {
    if (r0 < rows) {  // uniform across the block
      if (r0 > 0 || !kOwnRed) __syncthreads();  // red is free
      if (lane < G) {
#pragma unroll
        for (int q = 0; q < P && r0 + q < R; ++q)
#pragma unroll
          for (int c = 0; c < V; ++c) red[(warp * P + q) * kCols + lane * V + c] = acc[r0 + q][c];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < P * kCols; i += kThreads) {
        const int q = i / kCols, c = i - q * kCols;
        if (r0 + q < rows) {
          TA s = 0;
#pragma unroll
          for (int j = 0; j < kWarps; ++j) s += red[(j * P + q) * kCols + c];
          emit(r0 + q, c, s);
        }
      }
    }
  }
}

// Count this block in its tile's counter once every thread of the block
// has written its partial sums: thread 0 adds one with an acquire-release
// add (the barrier before makes the block's writes part of the release);
// the block that brings the count to `arrivals` is the last and resets
// the counter. `last` is shared memory. Returns whether this block was
// the last.
__device__ __forceinline__ bool arrive_last(int* count, int arrivals, int& last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(count)
                 : "memory");
    last = old == arrivals - 1;
    if (last) *count = 0;
  }
  __syncthreads();
  return last;
}

// s[p] = the sum over k ranges j = 0, 1, ..., split - 1 (in that order)
// of src[p * part_stride + j * range_stride], read through the L2 (other
// blocks wrote them): kParts sums side by side, C ranges of each in
// flight at once.
template <int kParts, typename TA>
__device__ __forceinline__ void range_sums(const TA* __restrict__ src, size_t part_stride,
                                           size_t range_stride, int split, TA (&s)[kParts]) {
  constexpr int C = kParts == 1 ? 16 : 8;
#pragma unroll
  for (int p = 0; p < kParts; ++p) s[p] = 0;
  for (int j = 0; j < split; j += C) {
    TA v[kParts][C];
#pragma unroll
    for (int p = 0; p < kParts; ++p)
#pragma unroll
      for (int t = 0; t < C; ++t)
        v[p][t] = j + t < split
                      ? __ldcg(src + p * part_stride + (size_t)(j + t) * range_stride)
                      : 0;
#pragma unroll
    for (int p = 0; p < kParts; ++p)
#pragma unroll
      for (int t = 0; t < C; ++t) s[p] += v[p][t];  // + 0 past split: exact, s is never -0
  }
}

// The split-K tail of one tile (kCols columns from col_begin, batch rows
// [row0, row0 + rows)) of `split` k ranges, once every thread of the
// block has written its partial sums part[j][row][col] (TA = f32 or s32):
// the last block of the tile (`arrive_last`) sums the ranges' partials in
// range order 0, 1, ... (`range_sums`) and hands each sum to emit(row,
// col, s) (columns below n). Returns whether this block was the last.
template <int kCols, typename TA, typename Emit>
__device__ __forceinline__ bool last_sums(const TA* __restrict__ part, int* count, int b, int n,
                                          int split, int col_begin, int row0, int rows, int& last,
                                          Emit emit) {
  if (!arrive_last(count, split, last)) return false;
  const size_t stride = (size_t)b * n;
  for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
    const int r = i / kCols, col = col_begin + i % kCols;
    if (col >= n) continue;
    TA s[1];
    range_sums<1>(part + (size_t)(row0 + r) * n + col, 0, stride, split, s);
    emit(row0 + r, col, s[0]);
  }
  return true;
}

// One tile of y = x @ W: columns [bx * G * kVec, (bx + 1) * G * kVec)
// (below n), k range by of `split` (rows [by * kper, min(m, (by + 1) *
// kper))) and batch rows [16 bz, 16 bz + R); gx column tiles. Rows of W,
// y and the partial sums lie `ld` elements apart (n for a whole matrix;
// gru_cell's gate is n = H columns of a row of 3H). G lanes side by side
// cover the block's columns; the 32 / G lane groups of a warp and the 8
// warps take different rows: 256 / G row slots a block. kStage: how x is
// staged (kStageFresh: f32, written earlier in this launch). kSlab: W's
// rows of this range are in `slab` (copy_slab, already waited for; the
// range is staged in one chunk of x), else they stream from global
// memory. Writes y, or with `part` this range's slice of the partial sums
// (part[(by * b + row) * ld + col]); leaves sm.xs in use by the warps'
// sums.
template <typename TX, typename TW, typename TY, int R, int G, int kStage, bool kSlab>
__device__ __forceinline__ void matvec_block(const TX* __restrict__ x, const TW* __restrict__ w,
                                             const uint4* slab, TY* __restrict__ y,
                                             float* __restrict__ part, int b, int m, int n,
                                             int ld, int kper, bool aligned, int bx, int by,
                                             int bz, Smem& sm) {
  constexpr int V = Lane<TW>::kVec, kCols = G * V, kSlots = kThreads / G;
  constexpr int kXsRows = kXsFloats / R;  // rows of x staged at a time
  // batch rows summed over the warps per pair of barriers (through xs)
  constexpr int kFit = kXsFloats / (kWarps * kCols), P = R < kFit ? R : kFit;
  float* xs = sm.xs;
  const int lane = threadIdx.x % 32;
  const int slot = row_slot<G>();  // this lane's first row
  const int col0 = bx * kCols + (lane % G) * V;
  const int row0 = bz * kBatchTile, rows = min(R, b - row0);
  const int k0 = by * kper, kend = min(m, k0 + kper);
  const bool live = col0 < n;

  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[r][c] = 0.f;

  for (int kx = k0; kx < kend; kx += kXsRows) {  // one chunk of staged x
    const int kc = min(kXsRows, kend - kx);
    const TW* wp = w + (size_t)kx * ld + col0;
    uint4 raw[kUnroll];
    // the lane's first rows of W are in flight while x is staged
    if (live) {
      if constexpr (kSlab) slab_rows<G>(raw, slab, slot, kSlots, kc);
      else load_rows(raw, wp, slot, kSlots, kc, col0, n, ld, aligned);
    }
    if (kx > k0) __syncthreads();  // every warp is done with the previous chunk
    if constexpr (kStage == kStageFresh)
      stage_x_fresh<R>(xs, x, m, row0, rows, kx, kc);
    else
      stage_x<TX, R>(xs, x, m, row0, rows, kx, kc);
    __syncthreads();
    if (live) {
      for (int kb = slot; kb < kc; kb += kSlots * kUnroll) {
        if (kb != slot) {
          if constexpr (kSlab) slab_rows<G>(raw, slab, kb, kSlots, kc);
          else load_rows(raw, wp, kb, kSlots, kc, col0, n, ld, aligned);
        }
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

  // into y (one k range) or into this range's slice of the partial sums
  block_sums<G, P, false>(acc, xs, rows, [&](int r, int i, float s) {
    const int col = bx * kCols + i;
    if (col < n) {
      if (part != nullptr)
        part[((size_t)by * b + row0 + r) * ld + col] = s;
      else
        y[(size_t)(row0 + r) * ld + col] = from_f<TY>(s);
    }
  });
}

template <typename TX, typename TW, typename TY, int R, int G>
__global__ void __launch_bounds__(kThreads, Resident<R>::kBlocks)
matvec_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TY* __restrict__ y,
              float* __restrict__ part, int* __restrict__ count, int b, int m, int n, int kper,
              bool aligned) {
  constexpr int kCols = G * Lane<TW>::kVec;
  __shared__ __align__(16) Smem sm;
  matvec_block<TX, TW, TY, R, G, kStageLoop, false>(x, w, nullptr, y, part, b, m, n, n, kper,
                                                    aligned, blockIdx.x, blockIdx.y, blockIdx.z,
                                                    sm);
  if (part == nullptr) return;
  // split k: the last block of this (column tile, batch tile) sums
  const int row0 = blockIdx.z * kBatchTile;
  last_sums<kCols>(part, count + blockIdx.z * gridDim.x + blockIdx.x, b, n, gridDim.y,
                   blockIdx.x * kCols, row0, min(R, b - row0), sm.last,
                   [&](int row, int col, float s) { y[(size_t)row * n + col] = from_f<TY>(s); });
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
