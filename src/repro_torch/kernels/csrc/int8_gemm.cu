// int8_gemm — w8a8 GEMM with fused dequantization:
//   y (b, n) f32 = (x_q (b, m) s8 @ w_q (m, n) s8, accumulated in s32)
//                  * x_scale[b] * w_scale[n]
// The epilogue is (float(acc) * x_scale) * w_scale, in that order and with
// no fused multiply-add, so y equals the plain version bit for bit.
//
// Replaces: src/repro/kernels/int8_gemm.py:41 int8_gemm (a PTQ'd leaf
// calls it once, a factored PTQ'd leaf twice: src/repro/quant/leaf.py).
//
// What bounds it on the H100: the bytes of w_q, m*n bytes, over
// 3.35 TB/s — half the bytes of the bf16 weight it was quantized from. At
// b <= 16 it does 2*b operations a byte, far below the int8 roofline.
//
// The design (decode_matvec's, matvec.cuh, in integers):
//   * Loads: a lane owns V = 16 neighbouring columns (16 bytes) of w_q (8
//     at R = 16, to keep 128 accumulators a thread) and reads 4 rows
//     k..k+3 of them (a quad) with ld.global.nc.L1::no_allocate vector
//     loads, kUnroll = 2 quads in flight. G lanes side by side (32, 16 or
//     8) cover G x V columns; the 32 / G lane groups of a warp and the 8
//     warps take different quads (256 / G quad slots).
//   * Arithmetic: w_q is row-major, so the 4 k of one column lie in 4
//     rows. Each 4 x 4-byte block is transposed in registers (8
//     __byte_perm), giving one word of 4 k values a column, and
//     __dp4a(w_pack, x_pack[r], acc[r][c]) adds 4 products. x_q is staged
//     in shared memory once as packs of 4 k a batch row (int32, zero past
//     the k range): one dp4a per byte of w_q per batch row.
//   * Split-K across blocks in one wave: `kernels/int8_gemm.plan` (Python,
//     tested on the CPU, on decode_matvec's rules) chooses G and the k
//     ranges (multiples of 16 rows). Each block writes its s32 partial
//     sums to a workspace; the last block of a (column tile, batch tile)
//     sums them (integers: exact in any order), dequantizes and resets the
//     tile's counter. That tail, and the block's sums over its warps (P
//     batch rows per pair of barriers, P = 512 / columns a block owns),
//     are matvec.cuh's `last_sums` and `block_sums`, on s32.
//   * Ragged edges are masked here: m not a multiple of 4 (the missing k
//     of the last quad read as zero), n not a multiple of V and rows off a
//     V-byte boundary (scalar loads, a branch uniform over the grid), and
//     b > 16 (blockIdx.z).
// Not the tensor cores: their s8 path wants w_q K-major, and it is stored
// (m, n) row-major as the reference stores it; at b <= 16 the bytes bound.
#include "matvec.cuh"

namespace {
namespace i8 {

using rk::mv::kBatchTile;  // batch rows a block holds at most
using rk::mv::kThreads;
using rk::mv::kWarps;

constexpr int kUnroll = 2;       // quads (4 rows) of w_q a lane has in flight
constexpr int kXsWords = 2048;   // x staged at a time: quads * R <= 2048 packs (8 KB)
constexpr int kRedCols = 512;    // P * columns a block owns (the warps' sums: 16 KB)

// columns (bytes of a row of w_q) a lane owns, by batch rows R
template <int R>
struct Lane {
  static constexpr int kVec = R <= 8 ? 16 : 8;
};

// blocks an SM the kernel is compiled to fit (registers), by batch rows
// R; RESIDENT in kernels/int8_gemm.py
template <int R>
struct Resident {
  static constexpr int kBlocks = R <= 4 ? 2 : 1;
};

// V bytes of one row through the read-only path, not allocated in L1
template <int V>
__device__ __forceinline__ void ld_row(uint32_t (&w)[V / 4], const int8_t* p) {
  if constexpr (V == 16) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
        : "l"(p));
  } else {
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(w[0]), "=r"(w[1]) : "l"(p));
  }
}

// the same bytes by scalar loads, zero past n: a row off a V-byte boundary
template <int V>
__device__ __forceinline__ void ld_row_ragged(uint32_t (&w)[V / 4], const int8_t* p, int col0,
                                              int n) {
#pragma unroll
  for (int j = 0; j < V / 4; ++j) w[j] = 0u;
#pragma unroll
  for (int c = 0; c < V; ++c)
    if (col0 + c < n) w[c / 4] |= (uint32_t)(uint8_t)__ldg(p + c) << (8 * (c % 4));
}

// Issue the loads of quads qb, qb + slots, ... (kUnroll of them): rows
// 4q..4q+3 of the lane's columns; rows at or past kc read as zero.
// `aligned` is the same for the whole grid.
template <int V>
__device__ __forceinline__ void load_quads(uint32_t (&raw)[kUnroll][4][V / 4], const int8_t* wp,
                                           int qb, int slots, int kc, int col0, int n,
                                           bool aligned) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * (qb + u * slots) + i;
      if (k >= kc) {
#pragma unroll
        for (int j = 0; j < V / 4; ++j) raw[u][i][j] = 0u;
      } else if (aligned) {
        ld_row<V>(raw[u][i], wp + (size_t)k * n);
      } else {
        ld_row_ragged<V>(raw[u][i], wp + (size_t)k * n, col0, n);
      }
    }
  }
}

// 4 rows a, b, c, d of 4 bytes (columns 0..3) -> 4 words, one a column,
// each holding (a, b, c, d) of that column from its low byte up
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t (&col)[4]) {
  const uint32_t ab01 = __byte_perm(a, b, 0x5140), cd01 = __byte_perm(c, d, 0x5140);
  const uint32_t ab23 = __byte_perm(a, b, 0x7362), cd23 = __byte_perm(c, d, 0x7362);
  col[0] = __byte_perm(ab01, cd01, 0x5410);
  col[1] = __byte_perm(ab01, cd01, 0x7632);
  col[2] = __byte_perm(ab23, cd23, 0x5410);
  col[3] = __byte_perm(ab23, cd23, 0x7632);
}

__device__ __forceinline__ float dequant(int s, float x_scale, float w_scale) {
  return __fmul_rn(__fmul_rn(__int2float_rn(s), x_scale), w_scale);
}

// Block (x, y, z) owns columns [x * G * V, (x + 1) * G * V), k range y
// (rows [y * kper, min(m, (y + 1) * kper))) and batch rows [16 z, 16 z + R).
template <int R, int G>
__global__ void __launch_bounds__(kThreads, Resident<R>::kBlocks)
int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ x_scale, const float* __restrict__ w_scale,
            float* __restrict__ y, int* __restrict__ part, int* __restrict__ count, int b, int m,
            int n, int kper, bool aligned) {
  constexpr int V = Lane<R>::kVec, kCols = G * V, kSlots = kThreads / G;
  constexpr int kXsQuads = kXsWords / R;  // quads of x staged at a time
  // batch rows summed over the warps per pair of barriers
  constexpr int P = kRedCols / kCols < R ? kRedCols / kCols : R;
  __shared__ int xs[kXsWords];            // [quad][R]: 4 k of one row packed
  __shared__ int red[kWarps][P][kCols];   // the warps' sums of P batch rows
  __shared__ int last;
  const int lane = threadIdx.x % 32;
  const int slot = rk::mv::row_slot<G>();  // this lane's first quad
  const int col0 = blockIdx.x * kCols + (lane % G) * V;
  const int row0 = blockIdx.z * kBatchTile, rows = min(R, b - row0);
  const int k0 = blockIdx.y * kper, kend = min(m, k0 + kper);
  const bool live = col0 < n;

  int acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[r][c] = 0;

  for (int kx = k0; kx < kend; kx += 4 * kXsQuads) {  // one chunk of staged x
    const int kc = min(4 * kXsQuads, kend - kx), qc = (kc + 3) / 4;
    const int8_t* wp = w + (size_t)kx * n + col0;
    uint32_t raw[kUnroll][4][V / 4];
    // the lane's first quads of w_q are in flight while x is staged
    if (live) load_quads<V>(raw, wp, slot, kSlots, kc, col0, n, aligned);
    if (kx > k0) __syncthreads();  // every warp is done with the previous chunk
    for (int i = threadIdx.x; i < R * qc; i += kThreads) {
      const int r = i / qc, q = i - r * qc;
      uint32_t pack = 0u;
      if (r < rows) {
        const int8_t* xr = x + (size_t)(row0 + r) * m + kx;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * q + j < kc) pack |= (uint32_t)(uint8_t)xr[4 * q + j] << (8 * j);
      }
      xs[q * R + r] = (int)pack;
    }
    __syncthreads();
    if (live) {
      for (int qb = slot; qb < qc; qb += kSlots * kUnroll) {
        if (qb != slot) load_quads<V>(raw, wp, qb, kSlots, kc, col0, n, aligned);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = qb + u * kSlots;
          if (q < qc) {
            const int* xq = xs + q * R;
#pragma unroll
            for (int j = 0; j < V / 4; ++j) {
              uint32_t col[4];
              transpose4(raw[u][0][j], raw[u][1][j], raw[u][2][j], raw[u][3][j], col);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const int xv = xq[r];
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  acc[r][4 * j + c] = __dp4a((int)col[c], xv, acc[r][4 * j + c]);
              }
            }
          }
        }
      }
    }
  }

  // into y (one k range) or into this range's partial sums
  rk::mv::block_sums<G, P, true>(acc, &red[0][0][0], rows, [=](int r, int i, int sum) {
    const int col = blockIdx.x * kCols + i;
    if (col < n) {
      if (part != nullptr)
        part[((size_t)blockIdx.y * b + row0 + r) * n + col] = sum;
      else
        y[(size_t)(row0 + r) * n + col] = dequant(sum, x_scale[row0 + r], w_scale[col]);
    }
  });
  if (part == nullptr) return;
  // split k: the last block of this (column tile, batch tile) sums and
  // dequantizes
  rk::mv::last_sums<kCols>(part, count + blockIdx.z * gridDim.x + blockIdx.x, b, n, gridDim.y,
                           blockIdx.x * kCols, row0, rows, last, [=](int row, int col, int sum) {
                             y[(size_t)row * n + col] = dequant(sum, x_scale[row], w_scale[col]);
                           });
}

}  // namespace i8
}  // namespace

#define RK_INT8_LAUNCH(G)                                                                  \
  i8::int8_kernel<R, G><<<grid, i8::kThreads, 0, s>>>(                                     \
      static_cast<const int8_t*>(x_q), wq, static_cast<const float*>(x_scale),             \
      static_cast<const float*>(w_scale), static_cast<float*>(y), p, c, b, m, n, kper,     \
      n % V == 0 && reinterpret_cast<uintptr_t>(wq) % V == 0)

// y = dequant(x_q @ w_q) in `split` k ranges of `kper` rows (a multiple of
// 4 when split > 1), G = `lanes` lanes across a row (the plan of
// kernels/int8_gemm.py). When split > 1, `part` holds split * b * n ints
// and `count` one zeroed int for each (column tile, batch tile), which the
// kernel leaves zeroed; neither is read otherwise.
extern "C" int rk_int8_gemm(const void* x_q, const void* w_q, const void* x_scale,
                            const void* w_scale, void* y, void* part, void* count, int b, int m,
                            int n, int lanes, int split, int kper, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || m <= 0 || n <= 0 || kper <= 0 || split <= 0 || split > 65535 ||
      (lanes != 8 && lanes != 16 && lanes != 32) || (long long)split * kper < m ||
      (long long)(split - 1) * kper >= m || (split > 1 && kper % 4 != 0) ||
      (split > 1 && (part == nullptr || count == nullptr)))
    return cudaErrorInvalidValue;
  const int8_t* wq = static_cast<const int8_t*>(w_q);
  int* p = split > 1 ? static_cast<int*>(part) : nullptr;
  int* c = split > 1 ? static_cast<int*>(count) : nullptr;
  RK_DISPATCH_ROWS(b, {
    constexpr int V = i8::Lane<R>::kVec;
    const dim3 grid((n + lanes * V - 1) / (lanes * V), split,
                    (b + i8::kBatchTile - 1) / i8::kBatchTile);
    if (grid.z > 65535) return cudaErrorInvalidValue;
    if (lanes == 32) RK_INT8_LAUNCH(32);
    else if (lanes == 16) RK_INT8_LAUNCH(16);
    else RK_INT8_LAUNCH(8);
  });
  return cudaGetLastError();
}

#undef RK_INT8_LAUNCH
