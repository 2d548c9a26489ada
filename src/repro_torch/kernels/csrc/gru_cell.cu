// gru_cell — one fused GRU step (paper eq. 10) from the precomputed
// non-recurrent projection xw:
//   hu = h @ U                      U (H, 3H), gates [z, r, hcand] along 3H
//   g  = xw + hu + bias             bias f32
//   z = sigmoid(g_z), r = sigmoid(g_r)
//   hcand = tanh(g_h - hu_h + r * hu_h)     r gates only U_h h
//   h' = (1 - z) * h + z * hcand
// f32 accumulation and gate math; h' in h's type, written to a fresh
// buffer (every block reads all of h, so h is never updated in place).
//
// Replaces: src/repro/kernels/gru_cell.py:36 gru_cell, which reshapes U
// to (H, 3, H) so one VMEM tile carries the three gate columns of a unit.
//
// What bounds it on the H100: the bytes of U, 3*H*H*sizeof(T), over
// 3.35 TB/s (H = 1280 in bf16: 9.8 MB, 2.9 us); at b <= 16 it does 2*b
// operations a weight element, far below the compute roofline, and the
// gate epilogue touches only b*H elements. At the DS2 widths U is 3.5-9.8
// MB a step: launch and L2 latency weigh as much as the bytes.
//
// The design: h @ U on the split-K tile of matvec.cuh (`matvec_block`:
// 16-byte no-L1 loads, G = 32, 16 or 8 lanes across a row, kUnroll rows
// in flight a lane, h staged as f32 [k][R], the warps' sums P batch rows
// per pair of barriers), with a gate epilogue in the split-K tail.
//   * Three gates of one unit cannot share a thread: at R = 16 batch rows
//     and V columns a lane that would be 3 * V * R accumulators. So U is
//     the (H, 3H) matrix it is, and each block owns one gate's column
//     tile: blockIdx.x = 3 * t + g covers gate g's columns g * H + t *
//     cols + [0, cols) (units below H), k range blockIdx.y, batch tile
//     blockIdx.z. `kernels/gru_cell.plan` (Python, tested on the CPU)
//     chooses G and the k ranges so the 3 * ceil(H / cols) column tiles
//     and their ranges fill one wave of resident blocks.
//   * Every block writes its partial sums to part[y][row][g * H + unit]
//     (a (split, b, 3H) f32 workspace, used even with one k range, since
//     the three gates always sit in different blocks) and counts itself
//     in one counter a (unit tile, batch tile): 3 * split arrivals.
//   * The last of them (matvec.cuh's `arrive_last`, which resets the
//     counter for the next launch or a replayed graph) sums each gate's
//     partials in range order 0, 1, ... (`range_sums`, the three gates'
//     loads in flight together, with xw, bias and h already requested),
//     applies the gates and writes h'. One launch, no floating-point
//     atomics, the same h' run to run whichever block comes last.
//   * U's rows lie on 16-byte boundaries when H % 8 == 0 in bf16 (H % 4 in
//     f32) and U does; otherwise a branch uniform over the grid reads
//     them with scalar loads (`load_ragged`). Batches above 16 take
//     blockIdx.z.
// With `stamps` (not null; kernels/gru_cell._launch) thread 0 of each
// block writes %globaltimer at its start, after its partial sums and at
// its end, for the tail's share of the launch.
#include "matvec.cuh"

namespace {

using rk::mv::kBatchTile;
using rk::mv::kThreads;

constexpr int kGates = 3;  // z, r, hcand: the column groups of U

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename T, int R, int G>
__global__ void __launch_bounds__(kThreads, rk::mv::Resident<R>::kBlocks)
gru_cell_kernel(const T* __restrict__ xw, const T* __restrict__ h, const T* __restrict__ u,
                const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ part,
                int* __restrict__ count, int b, int H, int kper, bool aligned,
                unsigned long long* stamps) {
  constexpr int kCols = G * rk::mv::Lane<T>::kVec;
  __shared__ __align__(16) rk::mv::Smem sm;
  unsigned long long* st = nullptr;
  if (stamps != nullptr && threadIdx.x == 0) {
    st = stamps + 3 * ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
    st[0] = globaltimer();
  }
  const int gate = blockIdx.x % kGates, tile = blockIdx.x / kGates;
  const int n3 = kGates * H;
  // gate's column tile of hu = h @ U, this k range's slice into part
  rk::mv::matvec_block<T, T, float, R, G, rk::mv::kStageLoop, false>(
      h, u + (size_t)gate * H, nullptr, nullptr, part + (size_t)gate * H, b, H, H, n3, kper,
      aligned, tile, blockIdx.y, blockIdx.z, sm);
  if (st != nullptr) st[1] = globaltimer();
  const bool last = rk::mv::arrive_last(count + blockIdx.z * (gridDim.x / kGates) + tile,
                                        kGates * gridDim.y, sm.last);
  if (last) {
    const int row0 = blockIdx.z * kBatchTile, rows = min(R, b - row0);
    const size_t range_stride = (size_t)b * n3;
    for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
      const int unit = tile * kCols + i % kCols;
      if (unit >= H) continue;
      const size_t row = row0 + i / kCols;
      // the epilogue's operands are in flight while the partials are summed
      const T* xrow = xw + row * n3 + unit;
      const float xz = rk::to_f(xrow[0]), xr = rk::to_f(xrow[H]), xh = rk::to_f(xrow[2 * H]);
      const float bz = bias[unit], br = bias[H + unit], bh = bias[2 * H + unit];
      const float hp = rk::to_f(h[row * H + unit]);
      float s[kGates];  // hu of the three gates, each summed in range order
      rk::mv::range_sums<kGates>(part + row * n3 + unit, H, range_stride, gridDim.y, s);
      const float gz = (xz + s[0]) + bz;
      const float gr = (xr + s[1]) + br;
      const float gh = (xh + s[2]) + bh;
      const float z = sigmoid(gz), rg = sigmoid(gr);
      const float hcand = tanhf(gh - s[2] + rg * s[2]);
      out[row * H + unit] = rk::from_f<T>((1.f - z) * hp + z * hcand);
    }
  }
  if (stamps != nullptr) {
    __syncthreads();  // every thread's tail is done
    if (st != nullptr) st[2] = globaltimer();
  }
}

// one launch with G lanes across a row
#define RK_GRU_LAUNCH(G)                                                             \
  gru_cell_kernel<T, R, G><<<grid, kThreads, 0, s>>>(                                \
      static_cast<const T*>(xw), static_cast<const T*>(h), static_cast<const T*>(u), \
      static_cast<const float*>(bias), static_cast<T*>(out), part, count, b, H, kper, \
      aligned, stamps)

// h' in `split` k ranges of `kper` rows, G = `lanes` lanes across a row
// (the plan of kernels/gru_cell.py). `part` holds split * b * 3H floats,
// `count` one zeroed int a (unit tile, batch tile) (left zeroed); `stamps`
// is null or 3 u64 a block.
template <typename T>
cudaError_t launch(const void* xw, const void* h, const void* u, const void* bias, void* out,
                   float* part, int* count, int b, int H, int lanes, int split, int kper,
                   unsigned long long* stamps, cudaStream_t s) {
  constexpr int V = rk::mv::Lane<T>::kVec;
  if (b <= 0 || H <= 0 || kper <= 0 || split <= 0 || split > 65535 ||
      (lanes != 8 && lanes != 16 && lanes != 32) || (long long)split * kper < H ||
      (long long)(split - 1) * kper >= H || part == nullptr || count == nullptr)
    return cudaErrorInvalidValue;
  const dim3 grid(kGates * ((H + lanes * V - 1) / (lanes * V)), split,
                  (b + kBatchTile - 1) / kBatchTile);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  const bool aligned = H % V == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  RK_DISPATCH_ROWS(b, {
    if (lanes == 32) RK_GRU_LAUNCH(32);
    else if (lanes == 16) RK_GRU_LAUNCH(16);
    else RK_GRU_LAUNCH(8);
  });
  return cudaGetLastError();
}

#undef RK_GRU_LAUNCH

}  // namespace

extern "C" int rk_gru_cell(const void* xw, const void* h, const void* u, const void* bias,
                           void* out, void* part, void* count, void* stamps, int b, int hidden,
                           int lanes, int split, int kper, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(count);
  auto* st = static_cast<unsigned long long*>(stamps);
  if (dtype == rk::kF32)
    return launch<float>(xw, h, u, bias, out, p, c, b, hidden, lanes, split, kper, st, s);
  if (dtype == rk::kBF16)
    return launch<__nv_bfloat16>(xw, h, u, bias, out, p, c, b, hidden, lanes, split, kper, st, s);
  return cudaErrorInvalidValue;
}
