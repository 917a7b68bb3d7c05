// K5: backward of the by-key sparse-conv gather-GEMM (K4), probe fused in.
//
// Replaces the Pallas TPU kernel `_bykey_bwd_kernel` of
// tsm_det_pointcloud_tpu/ops/spconv_pallas.py:383 (entry
// `gather_matmul_bykey_bwd`, :477). With row(b, k, q) the slot of skeys[b]
// that equals qkeys[b, k, q] (none when not found or >= sentinel):
//   dW[k]          = sum_{b, q found}  f[b, row]^T . g[b, q]        (C x Co)
//   df[b, row, :] += g[b, q] . W[k]^T                              (C)
//
// Bound: the two products (4 * C * Co flops per hit) against the bytes of
// f, g, df, W and dW once each: float32 operations bound the 128-wide convs
// of the main path, bytes the 64 x 64 ones whose taps hit sparsely.
// This first version is two plain tiled kernels on the CUDA cores, launched
// back to back by one entry:
//   * dW: a block owns one tap and one 64 x 64 tile of (C, Co) and walks a
//     strided share of the B * Q targets in chunks of 64. Per chunk it
//     binary-searches the 64 keys (as K4 does), skips the chunk when none
//     hits, stages the found f rows (zeros elsewhere) and the g rows in
//     shared memory and accumulates a 4 x 4 tile per thread in registers.
//     Blocks that share a tile (the target split) meet in atomicAdd.
//   * df: a block owns 64 targets x 64 input channels of one scan; per tap
//     it searches the keys, skips the tap when none hits, forms
//     g_tile . W[k]^T in 32-channel chunks through shared memory, and
//     atomicAdds each found row. Within one tap distinct targets name
//     distinct rows (subm, strided and inverse maps are injective per tap),
//     so collisions come only across taps and blocks.
// Float atomics make the summation order vary from run to run. No tensor
// cores (wgmma) or TMA yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;   // targets per chunk / block
constexpr int kCols = 64;   // channels per tile
constexpr int kChunk = 32;  // reduction channels per shared-memory stage (df)
constexpr int kThreads = 256;

// Slot of `key` in the ascending skeys row `sk` (length v), or -1.
__device__ __forceinline__ int find_slot(const int32_t* __restrict__ sk, int v, int32_t key,
                                         int sentinel) {
  if (key >= sentinel) return -1;
  int lo = 0, hi = v;  // lower bound
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(sk + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < v && __ldg(sk + lo) == key) ? lo : -1;
}

// grid (n_c_tiles * n_o_tiles, k_taps, splits)
__global__ void __launch_bounds__(kThreads)
bykey_dw_kernel(const float* __restrict__ f, const int32_t* __restrict__ skeys,
                const int32_t* __restrict__ qkeys, const float* __restrict__ g, int b_sz, int v,
                int c, int k_taps, int q, int co, int sentinel, float* __restrict__ dw) {
  __shared__ int s_slot[kRows];
  __shared__ float s_f[kRows][kCols + 1];
  __shared__ float s_g[kRows][kCols];

  const int n_o_tiles = (co + kCols - 1) / kCols;
  const int c0 = (blockIdx.x / n_o_tiles) * kCols;
  const int n0 = (blockIdx.x % n_o_tiles) * kCols;
  const int k = blockIdx.y;
  const int t = threadIdx.x;
  const int ty = t / 16;  // input channels c0 + ty*4 .. +3
  const int tx = t % 16;  // output channels n0 + tx*4 .. +3
  const int nq = (q + kRows - 1) / kRows;
  const int n_chunks = b_sz * nq;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int chunk = blockIdx.z; chunk < n_chunks; chunk += gridDim.z) {
    const int b = chunk / nq;
    const int q0 = (chunk % nq) * kRows;
    int slot = -1;
    if (t < kRows) {
      const int qi = q0 + t;
      if (qi < q)
        slot = find_slot(skeys + (size_t)b * v, v, qkeys[((size_t)b * k_taps + k) * q + qi],
                         sentinel);
      s_slot[t] = slot;
    }
    if (!__syncthreads_or(slot >= 0)) continue;  // no key of this chunk hits

    const float* fb = f + (size_t)b * v * c;
    const float* gb = g + (size_t)b * q * co;
    for (int e = t; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols;
      const int cc = e % kCols;
      const int sl = s_slot[r];
      s_f[r][cc] = (sl >= 0 && c0 + cc < c) ? __ldg(fb + (size_t)sl * c + c0 + cc) : 0.f;
      s_g[r][cc] = (sl >= 0 && n0 + cc < co) ? __ldg(gb + (size_t)(q0 + r) * co + n0 + cc)
                                             : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_f[r][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s_g[r][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = c0 + ty * 4 + i;
    if (ci >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn < co && acc[i][j] != 0.f)
        atomicAdd(dw + ((size_t)k * c + ci) * co + nn, acc[i][j]);
    }
  }
}

// grid (ceil(q / 64), ceil(c / 64), b)
__global__ void __launch_bounds__(kThreads)
bykey_df_kernel(const int32_t* __restrict__ skeys, const int32_t* __restrict__ qkeys,
                const float* __restrict__ w, const float* __restrict__ g, int v, int c,
                int k_taps, int q, int co, int sentinel, float* __restrict__ df) {
  __shared__ int s_slot[kRows];
  __shared__ float s_g[kChunk][kRows + 1];
  __shared__ float s_w[kChunk][kCols];

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kCols;
  const int t = threadIdx.x;
  const int ty = t / 16;  // targets q0 + ty*4 .. +3
  const int tx = t % 16;  // input channels c0 + tx*4 .. +3
  const int32_t* sk = skeys + (size_t)b * v;
  const float* gb = g + (size_t)b * q * co;
  float* dfb = df + (size_t)b * v * c;

  for (int k = 0; k < k_taps; ++k) {
    int slot = -1;
    if (t < kRows) {
      const int qi = q0 + t;
      if (qi < q) slot = find_slot(sk, v, qkeys[((size_t)b * k_taps + k) * q + qi], sentinel);
      s_slot[t] = slot;
    }
    if (!__syncthreads_or(slot >= 0)) continue;  // no key of this tap hits

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int n0 = 0; n0 < co; n0 += kChunk) {
      for (int e = t; e < kRows * kChunk; e += kThreads) {
        const int r = e / kChunk;
        const int nn = e % kChunk;
        s_g[nn][r] = (s_slot[r] >= 0 && n0 + nn < co)
                         ? __ldg(gb + (size_t)(q0 + r) * co + n0 + nn)
                         : 0.f;
      }
      for (int e = t; e < kChunk * kCols; e += kThreads) {
        const int cc = e / kChunk;
        const int nn = e % kChunk;
        s_w[nn][cc] = (c0 + cc < c && n0 + nn < co)
                          ? __ldg(w + ((size_t)k * c + c0 + cc) * co + n0 + nn)
                          : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int nn = 0; nn < kChunk; ++nn) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_g[nn][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = s_w[nn][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sl = s_slot[ty * 4 + i];
      if (sl < 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = c0 + tx * 4 + j;
        if (ci < c) atomicAdd(dfb + (size_t)sl * c + ci, acc[i][j]);
      }
    }
    __syncthreads();  // s_slot is rewritten by the next tap
  }
}

}  // namespace

// f (b, v, c) f32, skeys (b, v) i32 ascending, qkeys (b, k, q) i32,
// w (k, c, co) f32, g (b, q, co) f32; df (b, v, c) and dw (k, c, co) f32,
// both zeroed by the caller (the kernels add into them).
extern "C" int bykey_bwd_launch(const void* f, const void* skeys, const void* qkeys,
                                const void* w, const void* g, int b, int v, int c, int k_taps,
                                int q, int co, int sentinel, void* df, void* dw,
                                void* stream) {
  if (b <= 0 || v <= 0 || c <= 0 || k_taps <= 0 || q <= 0 || co <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = ((c + kCols - 1) / kCols) * ((co + kCols - 1) / kCols);
  const int n_chunks = b * ((q + kRows - 1) / kRows);
  // about four blocks per SM of an H100 (132 SMs) across taps and tiles
  int splits = (4 * 132 + k_taps * tiles - 1) / (k_taps * tiles);
  splits = splits < 1 ? 1 : (splits > n_chunks ? n_chunks : splits);
  dim3 grid_dw(tiles, k_taps, splits);
  bykey_dw_kernel<<<grid_dw, kThreads, 0, st>>>(
      static_cast<const float*>(f), static_cast<const int32_t*>(skeys),
      static_cast<const int32_t*>(qkeys), static_cast<const float*>(g), b, v, c, k_taps, q, co,
      sentinel, static_cast<float*>(dw));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_df((q + kRows - 1) / kRows, (c + kCols - 1) / kCols, b);
  bykey_df_kernel<<<grid_df, kThreads, 0, st>>>(
      static_cast<const int32_t*>(skeys), static_cast<const int32_t*>(qkeys),
      static_cast<const float*>(w), static_cast<const float*>(g), v, c, k_taps, q, co, sentinel,
      static_cast<float*>(df));
  return cudaGetLastError();
}
