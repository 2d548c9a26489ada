// flash_attention — blockwise online-softmax attention, causal or not:
//   o = softmax(q k^T / sqrt(d)) v      per (batch, head)
// q, k, v, o: (b, s, h, d) row-major, kv heads already repeated (GQA).
// Scores, running max m, running sum l and the accumulator are f32;
// masked scores are NEG_INF = -2^30 (finite, so exp never sees
// inf - inf); l is floored at 1e-30; o is written in the input type.
//
// Replaces: src/repro/kernels/flash_attention.py:62 flash_attention,
// whose grid (b*h, q tiles, kv tiles) carries (m, l, acc) in VMEM across
// the sequential kv axis and whose wrapper transposes q, k, v to
// (b*h, s, d) first (a full copy each) and asserts s % block == 0.
//
// What bounds it on the H100: operations. A causal call at b=1, s=4096,
// h=32, d=128 does 2*b*h*s^2*d = 1.37e11 FLOPs (QK^T and PV over the
// lower triangle): 0.139 ms at 989 TFLOP/s in bf16. Its bytes (q, k, v
// read once, o written once) are 134 MB: 0.040 ms at 3.35 TB/s.
//
// What the design does about it:
//   * One block owns one (b*h, 64-row q tile) and loops over the kv
//     tiles itself, keeping (m, l, acc) in registers: nothing carries
//     between blocks, so the TPU's sequential kv grid axis becomes a loop.
//     Causal blocks stop at the diagonal (the TPU's pl.when skip) and run
//     in reverse tile order, the longest first, to even out the tail.
//   * The (b, s, h, d) layout is read in place: one head row is d
//     contiguous values, loaded as 16-byte vectors; no transpose.
//   * Ragged q rows and kv columns are masked (zero-filled tiles, NEG_INF
//     scores, no store past s), so any s runs, and no small-shape
//     fallback is needed.
//   * bf16 (the prefill's type): the two products run on the tensor
//     cores with mma.sync m16n8k16 (bf16 in, f32 sums), FlashAttention-2
//     style: 4 warps, 16 q rows each; Q stays in registers as A fragments,
//     S = QK^T lands in the accumulator layout, which is re-packed to
//     bf16 A fragments of P for PV with no trip through shared memory.
//     P is rounded to bf16 for that product (l sums the f32 values).
//     Q, K and V tiles take 3 x 64 x (d + 8) x 2 bytes of shared memory
//     (52 KB at d = 128, above the 48 KB static limit: set as dynamic);
//     the 8-element row pad makes every fragment load conflict-free.
//   * f32: CUDA cores, a 16 x 16 thread grid with a 4 x 4 score tile
//     each, tiles staged as f32 in shared memory (113 KB at d = 128).
//   * Softmax in base 2: scores are pre-multiplied by log2(e)/sqrt(d) and
//     exponentiated with exp2f — the same function, one multiply fewer.
// Simple first: no TMA, no wgmma, no cp.async pipelining, no warp
// specialisation; K/V loads do not overlap the math within a block
// (other resident blocks cover them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1073741824.f;  // -2^30
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;  // q rows a block owns
constexpr int kBK = 64;  // kv rows a tile holds

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16).
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;            // 16 q rows each
constexpr int kPad = 8;              // bf16 elements of row pad in shared memory

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one register of two bf16 (lo in the low half), rounded to nearest even
__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 values as one register (lo in the low half)
__device__ __forceinline__ uint32_t pack_halves(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0 + 64) of one head (d contiguous bf16 each, row
// stride `ld` elements) into a shared tile of row stride D + kPad, as
// 16-byte vectors; rows at or past s are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                          size_t ld, int row0, int s) {
  constexpr int kVecs = D / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < kBQ * kVecs; i += kWarps * 32) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(tile + r * (D + kPad) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int s,
                 int h, int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = D + kPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * kLd;
  __nv_bfloat16* vs = ks + kBK * kLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma group (row) and thread-in-group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal tiles first
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const size_t ld = (size_t)h * D;                    // elements between rows of one head
  const size_t base = (size_t)bi * s * ld + (size_t)hi * D;

  load_tile<D>(qs, q + base, ld, q0, s);
  __syncthreads();
  // this warp's 16 q rows as A fragments, one per 16-wide k step
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* r0 = qs + (warp * 16 + g) * kLd + 2 * t4;
    const __nv_bfloat16* r1 = r0 + 8 * kLd;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      qf[t][0] = ld32(r0 + 16 * t);
      qf[t][1] = ld32(r1 + 16 * t);
      qf[t][2] = ld32(r0 + 16 * t + 8);
      qf[t][3] = ld32(r1 + 16 * t + 8);
    }
  }

  // rows g and g + 8 of the warp's 16: running max, this thread's share of
  // the running sum (the quad's four shares add up at the end), accumulator
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kv_end = causal ? min(s, q0 + kBQ) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(ks, k + base, ld, k0, s);
    load_tile<D>(vs, v + base, ld, k0, s);
    __syncthreads();

    // S = Q K^T: 16 x 64 per warp, eight n8 tiles of the accumulator layout
    float sc[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (8 * j + g) * kLd + 2 * t4;
#pragma unroll
      for (int t = 0; t < D / 16; ++t)
        mma_bf16(sc[j], qf[t], ld32(kr + 16 * t), ld32(kr + 16 * t + 8));
    }

    // scale into base 2, mask, and take the tile's row maxima
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t4 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float x = sc[j][e] * scale_log2;
        if (col >= s || (causal && col > row)) x = kNegInf;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);  // 0 on the first live tile (m = -2^30)
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - m[e >> 1]);
        sc[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: the accumulator layout of two neighbouring n8 tiles of S
    // is the A fragment of one 16-wide k step of P
#pragma unroll
    for (int tt = 0; tt < kBK / 16; ++tt) {
      uint32_t pa[4];
      pa[0] = pack_floats(sc[2 * tt][0], sc[2 * tt][1]);
      pa[1] = pack_floats(sc[2 * tt][2], sc[2 * tt][3]);
      pa[2] = pack_floats(sc[2 * tt + 1][0], sc[2 * tt + 1][1]);
      pa[3] = pack_floats(sc[2 * tt + 1][2], sc[2 * tt + 1][3]);
      const __nv_bfloat16* v0 = vs + (16 * tt + 2 * t4) * kLd + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vp = v0 + 8 * n;
        const uint32_t b0 = pack_halves(vp[0], vp[kLd]);
        const uint32_t b1 = pack_halves(vp[8 * kLd], vp[9 * kLd]);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  // the quad's four shares of l, floored; o = acc / l in bf16
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* oa = o + base + (size_t)row_a * ld + 2 * t4;
  __nv_bfloat16* ob = oa + 8 * ld;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row_a < s)
      *reinterpret_cast<uint32_t*>(oa + 8 * n) = pack_floats(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    if (row_b < s)
      *reinterpret_cast<uint32_t*>(ob + 8 * n) = pack_floats(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int b, int s, int h,
                       int causal, cudaStream_t stream) {
  constexpr int smem = 3 * kBQ * (D + kPad) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBQ - 1) / kBQ, b * h);
  flash_mma_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), s, h, causal,
      kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kTx = 16;  // threads along kv columns / output features
constexpr int kTy = 16;  // threads along q rows
constexpr int kRows = kBQ / kTy;  // q rows a thread holds (ty + 16 i)
constexpr int kCols = kBK / kTx;  // score columns a thread holds (tx + 16 j)

template <int D>
__global__ void __launch_bounds__(kTx * kTy)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int s, int h, int causal,
                  float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLdK = D + 1;    // pad: threads read K rows tx + 16 j at one k
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBQ][kLdK]
  float* ks = qs + kBQ * kLdK;                     // [kBK][kLdK]
  float* vs = ks + kBK * kLdK;                     // [kBK][D]
  float* ps = vs + kBK * D;                        // [kBQ][kBK + 1]

  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const size_t ld = (size_t)h * D;
  const size_t base = (size_t)bi * s * ld + (size_t)hi * D;

  for (int i = tid; i < kBQ * D; i += kTx * kTy) {
    const int r = i / D, c = i % D;
    qs[r * kLdK + c] = q0 + r < s ? q[base + (size_t)(q0 + r) * ld + c] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][D / kTx];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / kTx; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(s, q0 + kBQ) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile's readers are done (and Q is staged)
    for (int i = tid; i < kBK * D; i += kTx * kTy) {
      const int r = i / D, c = i % D;
      const bool live = k0 + r < s;
      const size_t off = base + (size_t)(k0 + r) * ld + c;
      ks[r * kLdK + c] = live ? k[off] : 0.f;
      vs[r * D + c] = live ? v[off] : 0.f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
    for (int kk = 0; kk < D; ++kk) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kTy * i) * kLdK + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + kTx * j) * kLdK + kk];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kTy * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + kTx * j;
        float x = sc[i][j] * scale_log2;
        if (col >= s || (causal && col > row)) x = kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of one row are the 16 lanes of one half-warp
#pragma unroll
      for (int off = kTx / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = exp2f(sc[i][j] - m_new);
        ps[(ty + kTy * i) * (kBK + 1) + tx + kTx * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < D / kTx; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

    for (int kk = 0; kk < kBK; ++kk) {
      float vv[D / kTx];
#pragma unroll
      for (int c = 0; c < D / kTx; ++c) vv[c] = vs[kk * D + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(ty + kTy * i) * (kBK + 1) + kk];
#pragma unroll
        for (int c = 0; c < D / kTx; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTy * i;
    if (row >= s) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + base + (size_t)row * ld;
#pragma unroll
    for (int c = 0; c < D / kTx; ++c) orow[tx + kTx * c] = acc[i][c] * inv_l;
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, int b, int s, int h,
                        int causal, cudaStream_t stream) {
  constexpr int smem =
      (int)sizeof(float) * ((kBQ + kBK) * (D + 1) + kBK * D + kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_simt_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBQ - 1) / kBQ, b * h);
  flash_simt_kernel<D><<<grid, kTx * kTy, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, h, causal, kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

extern "C" int rk_flash_attention(const void* q, const void* k, const void* v, void* o, int b,
                                  int s, int h, int d, int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || h <= 0 || b * h > 65535) return cudaErrorInvalidValue;
  if (dtype == rk::kBF16) {
    if (d == 64) return launch_mma<64>(q, k, v, o, b, s, h, causal, st);
    if (d == 128) return launch_mma<128>(q, k, v, o, b, s, h, causal, st);
  } else if (dtype == rk::kF32) {
    if (d == 64) return launch_simt<64>(q, k, v, o, b, s, h, causal, st);
    if (d == 128) return launch_simt<128>(q, k, v, o, b, s, h, causal, st);
  }
  return cudaErrorInvalidValue;
}
