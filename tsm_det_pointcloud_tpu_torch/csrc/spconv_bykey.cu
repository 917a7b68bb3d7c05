// K4: by-key sparse-conv gather-GEMM, with the rulebook probe fused in.
//
// Replaces the Pallas TPU kernel `_bykey_kernel` of
// tsm_det_pointcloud_tpu/ops/spconv_pallas.py:132:
//   out[b, q, :] = sum_k  W[k]^T . f[b, row(skeys[b] == qkeys[b, k, q]), :]
// where a key that is not found (or is >= sentinel) contributes zero.
//
// Bound: at the main path's widths (C, Co in {64, 128}) the product is the
// work (up to ~58 GFLOP for the largest conv when every tap hits), so the
// bound is float32 operations. This first version is a plain tiled GEMM on
// the CUDA cores: a block owns 64 target rows x 64 output channels; per tap
// it binary-searches the 64 keys (12 steps at V = 4096), skips the tap when
// no key hits, stages the found feature rows (zeros where not found) and
// the tap's weight slice through shared memory in chunks of 32 input
// channels, and accumulates a 4 x 4 micro-tile per thread in f32 registers.
// The product never leaves the kernel. No tensor cores (wgmma) or TMA yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;   // target rows per block
constexpr int kCols = 64;   // output channels per block
constexpr int kChunk = 32;  // input channels per shared-memory stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bykey_kernel(const float* __restrict__ f, const int32_t* __restrict__ skeys,
             const int32_t* __restrict__ qkeys, const float* __restrict__ w, int v, int c,
             int k_taps, int q, int co, int sentinel, float* __restrict__ out) {
  __shared__ int s_slot[kRows];
  __shared__ float s_g[kChunk][kRows + 1];
  __shared__ float s_w[kChunk][kCols];

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kCols;
  const int t = threadIdx.x;
  const int ty = t / 16;  // rows ty*4 .. ty*4+3
  const int tx = t % 16;  // cols tx*4 .. tx*4+3
  const int32_t* sk = skeys + (size_t)b * v;
  const float* fb = f + (size_t)b * v * c;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < k_taps; ++k) {
    int slot = -1;
    if (t < kRows) {
      const int qi = q0 + t;
      if (qi < q) {
        const int32_t key = qkeys[((size_t)b * k_taps + k) * q + qi];
        if (key < sentinel) {
          int lo = 0, hi = v;  // lower bound
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__ldg(sk + mid) < key) {
              lo = mid + 1;
            } else {
              hi = mid;
            }
          }
          if (lo < v && __ldg(sk + lo) == key) slot = lo;
        }
      }
      s_slot[t] = slot;
    }
    if (!__syncthreads_or(slot >= 0)) continue;  // no key of this tap hits

    for (int c0 = 0; c0 < c; c0 += kChunk) {
      for (int e = t; e < kRows * kChunk; e += kThreads) {
        const int r = e / kChunk;
        const int cc = e % kChunk;
        const int sl = s_slot[r];
        s_g[cc][r] = (sl >= 0 && c0 + cc < c) ? __ldg(fb + (size_t)sl * c + c0 + cc) : 0.f;
      }
      for (int e = t; e < kChunk * kCols; e += kThreads) {
        const int cc = e / kCols;
        const int nn = e % kCols;
        s_w[cc][nn] = (c0 + cc < c && n0 + nn < co)
                          ? __ldg(w + ((size_t)k * c + c0 + cc) * co + n0 + nn)
                          : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < kChunk; ++cc) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_g[cc][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = s_w[cc][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn < co) out[((size_t)b * q + qi) * co + nn] = acc[i][j];
    }
  }
}

}  // namespace

// f (b, v, c) f32, skeys (b, v) i32 ascending, qkeys (b, k, q) i32,
// w (k, c, co) f32; out (b, q, co) f32.
extern "C" int bykey_launch(const void* f, const void* skeys, const void* qkeys, const void* w,
                            int b, int v, int c, int k_taps, int q, int co, int sentinel,
                            void* out, void* stream) {
  if (b <= 0 || v <= 0 || c <= 0 || k_taps <= 0 || q <= 0 || co <= 0)
    return cudaErrorInvalidValue;
  dim3 grid((q + kRows - 1) / kRows, (co + kCols - 1) / kCols, b);
  bykey_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const int32_t*>(skeys),
      static_cast<const int32_t*>(qkeys), static_cast<const float*>(w), v, c, k_taps, q, co,
      sentinel, static_cast<float*>(out));
  return cudaGetLastError();
}
