// flash_attention — blockwise online-softmax attention, causal or not:
//   o = softmax(q k^T / sqrt(d)) v      per (batch, head)
// q, o: (b, s, h, d) and k, v: (b, s, h_kv, d) row-major, h % h_kv == 0:
// q head j reads kv head j / (h / h_kv) in place (GQA, no repeat).
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
// lower triangle): 0.139 ms at 989 TFLOP/s in bf16, a rate only wgmma
// reaches. Its bytes (q, k, v read once, o written once) are 134 MB:
// 0.040 ms at 3.35 TB/s. Beside the tensor cores, the exp2 of every score
// runs on the SFU (16 a clock an SM), ~half the MMA time at d = 128.
//
// The design, bf16 (the prefill's type), FlashAttention-3-shaped:
//   * A block owns one (batch, head) and a 128-row q tile, and loops over
//     the kv tiles itself, (m, l, acc) in registers: nothing carries
//     between blocks, so the TPU's sequential kv grid axis becomes a loop.
//     The grid is (b*h, q tiles) with the head as the fast axis and the q
//     tiles in reverse order, so the first wave takes every head's longest
//     causal tile (longest first); causal blocks stop at the diagonal.
//   * Warp specialisation: 384 threads = two consumer warpgroups (each
//     owns 64 of the q rows) and a producer warpgroup, of which one warp
//     works: one lane issues every load as TMA (cp.async.bulk.tensor):
//     Q once, then K and V tiles of 128 kv rows into a ring of kStages = 2
//     stages, each with its own full-K, full-V and empty mbarriers. At
//     d = 128 that is Q 32 KB + 2 x (32 + 32) KB = 160 KB of shared
//     memory, one block an SM; while the consumers work on one stage the
//     next stage's 64 KB are in flight. K of a tile arrives (and S starts)
//     before its V. setmaxnreg moves registers from the producer (24 a
//     thread) to the consumers (240), whose S and O accumulators take 128.
//   * Layout: (b, s, h, d) is read in place through 4-D tensor maps
//     (d, h, s, b), one box a (64 columns = 128 bytes, 1 head, 128 rows,
//     1 batch) panel at a column offset inside the head, with 128-byte
//     swizzle: no transpose, and rows past s (ragged tiles) and columns
//     past d are zero-filled by TMA. The head is a dimension of its own so
//     that a head width off the 64-column panel (stablelm's d = 80,
//     zamba2's d = 112) reads zeros past its last column, not the next
//     head's: a d = 80 or d = 112 head is staged as two panels, columns
//     80..127 or 112..127 zero. The maps are encoded on
//     the host (cuTensorMapEncodeTiled, libcuda) and passed as
//     __grid_constant__ parameters.
//   * Products: S = Q K^T is wgmma.mma_async m64n128k16 (bf16 in, f32
//     sums) with A (Q) and B (K) both K-major in swizzled shared memory;
//     the S accumulator is re-packed in registers to bf16 A fragments of P
//     (its layout per 8 columns is that of mma.sync), and O += P V is
//     wgmma with A from registers and V as an MN-major B (transpose bit).
//     P is rounded to bf16 for that product (l sums the f32 values).
//     Q K^T takes d/16 k-steps (5 at d = 80, 7 at d = 112: the zero
//     columns are skipped); P V runs at the panels' width (N = 128 at
//     d = 80 and 112, the
//     zero columns of V giving zero columns of O), and the store writes
//     the d columns of each head.
//   * Softmax in base 2 (scores pre-multiplied by log2(e)/sqrt(d),
//     exp2f), as before. The causal and ragged mask is evaluated only on
//     the tiles that need it (the diagonal one and a ragged last one).
// Not done yet: FlashAttention-3's schedules. Both were tried and
// measured slower than this loop: a ping-pong of the two warpgroups
// through named barriers (each issuing tile i's P V with tile i + 1's
// Q K^T in its turn), and the overlap of tile i + 1's softmax with tile
// i's P V inside a warpgroup, which ptxas serialized (its accumulator
// registers are read between the products' issue and wait). Nor a
// persistent tile loop, TMA stores of O, fp8: the output is stored from
// registers.
//
// f32 (the tests' exact checks): CUDA cores, a 16 x 16 thread grid with a
// 4 x 4 score tile each, tiles staged as f32 in shared memory (113 KB at
// d = 128), 64-row q and kv tiles.
//
// Head widths: 64, 80 (stablelm-3b), 112 (zamba2-7b's shared attention)
// and 128, both types; 80 and 112 take d = 128's shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1073741824.f;  // -2^30
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;  // f32 path: q rows a block owns
constexpr int kBK = 64;  // f32 path: kv rows a tile holds

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised.
// ---------------------------------------------------------------------------

namespace tma {

constexpr int kBQ = 128;       // q rows a block owns: two warpgroups of 64
constexpr int kBK = 128;       // kv rows a stage holds
constexpr int kStages = 2;
constexpr int kConsumerWarps = 8;                    // warpgroups 0 and 1
constexpr int kThreads = (kConsumerWarps + 4) * 32;  // + the producer warpgroup
// Registers a thread: 168 at launch (64K over 384 threads); the producer
// warpgroup gives all but 24 back and the consumers take them: 128 x
// (168 - 24) = 256 x (240 - 168).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kPanel = 64;     // bf16 columns of one 128-byte swizzled panel

// Shared memory, in bytes from a 1024-byte aligned base (128-byte swizzle
// atoms are 8 rows x 128 bytes): Q, then the K stages, then the V stages,
// each a run of ceil(d/64) panels of (rows x 128 bytes); then the
// mbarriers.
template <int D>
struct Layout {
  static constexpr int kPanels = (D + kPanel - 1) / kPanel;
  static constexpr int kWidth = kPanels * kPanel;  // P V's N: d padded to panels
  static constexpr int kPanelQ = kBQ * 128;
  static constexpr int kPanelKV = kBK * 128;
  static constexpr int kQBytes = kPanels * kPanelQ;
  static constexpr int kKVBytes = kPanels * kPanelKV;  // one K or V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;  // Q, full K, full V, empty
  static constexpr int kBytes = kBar + (1 + 3 * kStages) * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The mbarriers follow Q's (bar_q): full K of each stage, full V of each
// stage, empty of each stage.
__device__ __forceinline__ uint32_t bar_full_k(uint32_t bar_q, int st) {
  return bar_q + 8u * (1 + st);
}
__device__ __forceinline__ uint32_t bar_full_v(uint32_t bar_q, int st) {
  return bar_q + 8u * (1 + kStages + st);
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t bar_q, int st) {
  return bar_q + 8u * (1 + 2 * kStages + st);
}

// one box of a 4-D tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulator
// registers across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// two floats as one register of two bf16 (lo in the low half), rounded to nearest even
__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 in, f32 accumulate; N/2 accumulator floats a thread.
// Thread (warp w of the warpgroup, lane 4g + t) holds, per 8 columns j,
// d[4j + 0..1] = row 16w + g, cols 8j + 2t, +1 and d[4j + 2..3] = row
// 16w + g + 8, the same cols.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d (64 x 64, f32) += A (64 x 16, smem) * B (16 x 64, smem), both K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128, f32) += A (64 x 16, smem) * B (16 x 128, smem), both K-major
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// The consumer warpgroups' work: warpgroup wg owns q rows
// [q0 + 64 wg, q0 + 64 wg + 64) of q head hi, batch bi.
template <int D>
__device__ __forceinline__ void consume(uint32_t sq, uint32_t sk, uint32_t sv, uint32_t bar_q,
                                        __nv_bfloat16* __restrict__ o, int s, int h, int hi,
                                        int bi, int q0, int n_tiles, int causal,
                                        float scale_log2) {
  using L = Layout<D>;
  constexpr int kN = L::kWidth;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int wg_row0 = q0 + 64 * wg;
  const int row_a = wg_row0 + 16 * (warp % 4) + g, row_b = row_a + 8;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = i * kBK;

    // S = Q K^T: 64 x 128 per warpgroup, K-major A and B, d/16 k-steps;
    // a k-step is 32 bytes into a 128-byte panel row
    float sc[kBK / 2];
    mbar_wait(bar_full_k(bar_q, st), phase);
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = sq + (kk / 4) * L::kPanelQ + wg * 64 * 128 + (kk % 4) * 32;
      const uint32_t b = sk + st * L::kKVBytes + (kk / 4) * L::kPanelKV + (kk % 4) * 32;
      Wgmma<kBK>::ss(sc, desc(a, 16, 1024), desc(b, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // scale into base 2, mask (diagonal and ragged tiles only), row maxima
    const bool masked = k0 + kBK > s || (causal && k0 + kBK - 1 > wg_row0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (masked) {
          const int col = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= s || (causal && col > row)) x = kNegInf;
        }
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);  // 0 on the first tile (m = -2^30)
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const float p = exp2f(sc[j] - m[(j >> 1) & 1]);
      sc[j] = p;
      l[(j >> 1) & 1] += p;
    }
    // P as bf16 A fragments: k-step tt covers S's 8-column tiles 2tt, 2tt+1
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int tt = 0; tt < kBK / 16; ++tt) {
      pf[tt][0] = pack_floats(sc[8 * tt + 0], sc[8 * tt + 1]);
      pf[tt][1] = pack_floats(sc[8 * tt + 2], sc[8 * tt + 3]);
      pf[tt][2] = pack_floats(sc[8 * tt + 4], sc[8 * tt + 5]);
      pf[tt][3] = pack_floats(sc[8 * tt + 6], sc[8 * tt + 7]);
    }
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];

    // O += P V: V (kv rows x d) is an MN-major B; a k-step is 16 kv rows
    // (2 KB) further, the d panels are kPanelKV apart (the leading offset)
    mbar_wait(bar_full_v(bar_q, st), phase);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int tt = 0; tt < kBK / 16; ++tt) {
      const uint32_t b = sv + st * L::kKVBytes + tt * 16 * 128;
      Wgmma<kN>::rs(acc, pf[tt], desc(b, L::kPanelKV, 1024), 1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(bar_q, st));  // this warp is done with the stage
  }

  // the quad's four shares of l, floored; o = acc / l in bf16
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const size_t ld = (size_t)h * D;
  __nv_bfloat16* oa = o + (size_t)bi * s * ld + (size_t)hi * D + (size_t)row_a * ld + 2 * t4;
  __nv_bfloat16* ob = oa + 8 * ld;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row_a < s)
      *reinterpret_cast<uint32_t*>(oa + 8 * n) =
          pack_floats(acc[4 * n] * inv[0], acc[4 * n + 1] * inv[0]);
    if (row_b < s)
      *reinterpret_cast<uint32_t*>(ob + 8 * n) =
          pack_floats(acc[4 * n + 2] * inv[1], acc[4 * n + 3] * inv[1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                 int s, int h, int h_kv, int causal, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem_tma[];
  const uint32_t base = (smem_u32(smem_tma) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;

  const int hi = blockIdx.x % h, bi = blockIdx.x / h;
  const int hk = hi / (h / h_kv);                       // the kv head this q head reads
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;    // longest causal tiles first
  const int kv_end = causal ? min(s, q0 + kBQ) : s;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full_k(bar_q, st), 1);
      mbar_init(bar_full_v(bar_q, st), 1);
      mbar_init(bar_empty(bar_q, st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    // producer warpgroup: one lane of its first warp issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(sq + p * L::kPanelQ, &map_q, bar_q, p * kPanel, hi, q0, bi);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(bar_empty(bar_q, st), ((i / kStages) & 1) ^ 1);  // passes at once on the first round
        mbar_expect_tx(bar_full_k(bar_q, st), L::kKVBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sk + st * L::kKVBytes + p * L::kPanelKV, &map_k, bar_full_k(bar_q, st),
                   p * kPanel, hk, i * kBK, bi);
        mbar_expect_tx(bar_full_v(bar_q, st), L::kKVBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sv + st * L::kKVBytes + p * L::kPanelKV, &map_v, bar_full_v(bar_q, st),
                   p * kPanel, hk, i * kBK, bi);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<D>(sq, sk, sv, bar_q, o, s, h, hi, bi, q0, n_tiles, causal, scale_log2);
  }
}

// A 4-D tensor map over (b, s, heads, D) bf16 as (D, heads, s, b), one box
// a (64 columns, 1 head, `rows` rows, 1 batch) panel with 128-byte
// swizzle; columns past D and rows past s are zero-filled on load.
bool encode_map(CUtensorMap* map, const void* ptr, int b, int s, int heads, int d, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, 1u, (cuuint32_t)rows, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int s, int h,
                   int h_kv, int causal, cudaStream_t stream) {
  // TMA wants 16-byte aligned bases (head pitches d*2 are multiples of 16)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, b, s, h, D, kBQ) || !encode_map(&mk, k, b, s, h_kv, D, kBK) ||
      !encode_map(&mv, v, b, s, h_kv, D, kBK))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_tma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  flash_tma_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), s, h, h_kv, causal, kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace tma

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
                  const float* __restrict__ v, float* __restrict__ o, int s, int h, int h_kv,
                  int causal, float scale_log2) {
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
  const size_t ld_kv = (size_t)h_kv * D;  // q head hi reads kv head hi / (h / h_kv)
  const size_t base_kv = (size_t)bi * s * ld_kv + (size_t)(hi / (h / h_kv)) * D;

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
      const size_t off = base_kv + (size_t)(k0 + r) * ld_kv + c;
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
                        int h_kv, int causal, cudaStream_t stream) {
  constexpr int smem =
      (int)sizeof(float) * ((kBQ + kBK) * (D + 1) + kBK * D + kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_simt_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBQ - 1) / kBQ, b * h);
  flash_simt_kernel<D><<<grid, kTx * kTy, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, h, h_kv, causal, kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

extern "C" int rk_flash_attention(const void* q, const void* k, const void* v, void* o, int b,
                                  int s, int h, int h_kv, int d, int causal, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || h <= 0 || h_kv <= 0 || h % h_kv != 0) return cudaErrorInvalidValue;
  if (dtype == rk::kBF16) {
    if ((long long)b * h > 0x7fffffff || (s + tma::kBQ - 1) / tma::kBQ > 65535)
      return cudaErrorInvalidValue;
    if (d == 64) return tma::launch<64>(q, k, v, o, b, s, h, h_kv, causal, st);
    if (d == 80) return tma::launch<80>(q, k, v, o, b, s, h, h_kv, causal, st);
    if (d == 112) return tma::launch<112>(q, k, v, o, b, s, h, h_kv, causal, st);
    if (d == 128) return tma::launch<128>(q, k, v, o, b, s, h, h_kv, causal, st);
  } else if (dtype == rk::kF32) {
    if (b * h > 65535) return cudaErrorInvalidValue;
    if (d == 64) return launch_simt<64>(q, k, v, o, b, s, h, h_kv, causal, st);
    if (d == 80) return launch_simt<80>(q, k, v, o, b, s, h, h_kv, causal, st);
    if (d == 112) return launch_simt<112>(q, k, v, o, b, s, h, h_kv, causal, st);
    if (d == 128) return launch_simt<128>(q, k, v, o, b, s, h, h_kv, causal, st);
  }
  return cudaErrorInvalidValue;
}
