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
// 3.35 TB/s (H = 1280 in bf16: 9.8 MB, 2.9 us); the gate epilogue touches
// only b*H elements.
//
// What the design does about it: the matvec skeleton of common.cuh, but
// lane i of a block reads U[k, i], U[k, H + i] and U[k, 2H + i], so the
// three gate sums of unit i land in one thread without any reshape, and
// each of the three reads is coalesced across the warp. The three sums
// are reduced across the block's warps one gate at a time through one
// shared buffer, then the epilogue applies the gates. U is read once; the
// recurrent product never leaves the chip.
#include "common.cuh"

namespace {

using rk::kChunk;
using rk::kCols;
using rk::kRowsMax;
using rk::kSplit;
using rk::kThreads;

// Sum the block's kSplit partial sums of one gate: thread tid gets the
// (row, column) pairs tid, tid + kThreads, ... in s[].
template <int R, int P>
__device__ __forceinline__ void reduce_gate(float (*red)[R][kCols], const float (&acc)[R],
                                            float (&s)[P]) {
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * kCols + lane;
  __syncthreads();  // the buffer's previous readers are done
#pragma unroll
  for (int r = 0; r < R; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = tid + p * kThreads;
    s[p] = 0.f;
    if (i < R * kCols) {
      const int r = i / kCols, c = i % kCols;
#pragma unroll
      for (int j = 0; j < kSplit; ++j) s[p] += red[j][r][c];
    }
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
gru_cell_kernel(const T* __restrict__ xw, const T* __restrict__ h, const T* __restrict__ u,
                const float* __restrict__ bias, T* __restrict__ out, int b, int H) {
  __shared__ float hs[kChunk][R + 1];
  __shared__ float red[kSplit][R][kCols];
  constexpr int P = (R * kCols + kThreads - 1) / kThreads;
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * kCols + lane;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kRowsMax;
  const int rows = min(R, b - row0);
  const size_t n3 = 3 * (size_t)H;

  float az[R], ar[R], ah[R];
#pragma unroll
  for (int r = 0; r < R; ++r) az[r] = ar[r] = ah[r] = 0.f;

  for (int k0 = 0; k0 < H; k0 += kChunk) {
    const int kc = min(kChunk, H - k0);
    __syncthreads();
    rk::stage_rows<T, R>(hs, h, H, row0, rows, k0, kc);
    __syncthreads();
    if (col < H) {
      const T* uk = u + (size_t)k0 * n3 + col;
#pragma unroll 2
      for (int k = warp; k < kc; k += kSplit) {
        const T* p = uk + (size_t)k * n3;
        const float wz = rk::to_f(p[0]), wr = rk::to_f(p[H]), wh = rk::to_f(p[2 * H]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = hs[k][r];
          az[r] += hv * wz;
          ar[r] += hv * wr;
          ah[r] += hv * wh;
        }
      }
    }
  }

  float sz[P], sr[P], sh[P];
  reduce_gate<R, P>(red, az, sz);
  reduce_gate<R, P>(red, ar, sr);
  reduce_gate<R, P>(red, ah, sh);

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = tid + p * kThreads;
    const int r = i / kCols, gc = blockIdx.x * kCols + i % kCols;
    if (i < R * kCols && r < rows && gc < H) {
      const size_t row = row0 + r;
      const T* xr = xw + row * n3;
      const float gz = (rk::to_f(xr[gc]) + sz[p]) + bias[gc];
      const float gr = (rk::to_f(xr[H + gc]) + sr[p]) + bias[H + gc];
      const float gh = (rk::to_f(xr[2 * H + gc]) + sh[p]) + bias[2 * H + gc];
      const float z = sigmoid(gz), rg = sigmoid(gr);
      const float hcand = tanhf(gh - sh[p] + rg * sh[p]);
      const float hp = rk::to_f(h[row * H + gc]);
      out[row * H + gc] = rk::from_f<T>((1.f - z) * hp + z * hcand);
    }
  }
}

template <typename T>
cudaError_t launch(const void* xw, const void* h, const void* u, const void* bias, void* out,
                   int b, int H, cudaStream_t s) {
  RK_DISPATCH_ROWS(b, gru_cell_kernel<T, R><<<rk_grid(b, H), dim3(kCols, kSplit), 0, s>>>(
                          static_cast<const T*>(xw), static_cast<const T*>(h),
                          static_cast<const T*>(u), static_cast<const float*>(bias),
                          static_cast<T*>(out), b, H));
  return cudaGetLastError();
}

}  // namespace

extern "C" int rk_gru_cell(const void* xw, const void* h, const void* u, const void* bias,
                           void* out, int b, int hidden, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rk::kF32) return launch<float>(xw, h, u, bias, out, b, hidden, s);
  if (dtype == rk::kBF16) return launch<__nv_bfloat16>(xw, h, u, bias, out, b, hidden, s);
  return cudaErrorInvalidValue;
}
