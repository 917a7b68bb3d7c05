// K7: index-based sparse-conv gather-GEMM over a materialised rulebook.
//
// Replaces the Pallas TPU kernel `_kernel` of
// tsm_det_pointcloud_tpu/ops/spconv_pallas.py:45 (its pallas_call at :106,
// entry `gather_matmul` at :618):
//   out[b, q, :] = sum_k  W[k]^T . f[b, idx[b, k, q], :]
// where an index of -1 contributes zero. f32 in, f32 accumulation, f32 out.
//
// The TPU kernel builds a one-hot matrix over a window of source rows and
// multiplies it on the MXU, because Mosaic has no vector gather, and it
// drops to bf16 when the padded feature block passes its 12 MB VMEM budget.
// Neither carries over: here a block loads its rows by index from device
// memory / L2 and stays in f32.
//
// Bound: operations 2 * hits * C * Co at 67 TFLOP/s (f32, CUDA cores), or
// bytes (idx read once, the gathered rows read once, W, out written once) at
// 3.35 TB/s, whichever is larger. SECOND's stem (C in {4, 16, 32, 64}, Co in
// {16, 32, 64, 128}, K = 27 or 3, V = Q = 40000 a scan) is bytes-bound at
// its narrow convs (C = 4 / Co = 16 moves ~17 MB of indices for ~0.5 GFLOP)
// and near the balance point at the 64-wide ones.
//
// This first version is a plain tiled GEMM on the CUDA cores, in the shape
// of K4 (csrc/spconv_bykey.cu): a block owns TM target rows x TN output
// channels, 256 threads, a 4 x 4 micro-tile a thread in f32 registers. Per
// tap it loads the TM indices, skips the tap when every one is -1, and
// stages the indexed feature rows (zeros where -1) and the tap's weight
// slice through shared memory in chunks of up to 32 input channels; the
// staging loop maps consecutive threads to consecutive channels of
// consecutive rows, so a narrow C (4, 16) still loads whole rows per warp,
// and the inner product runs only over the chunk's real channels. The
// output tile follows Co (TN = 16, 32 or 64 with TM = 4096 / TN), so Co = 16
// does not idle three quarters of a 64-wide tile. What it does not do yet:
// tensor cores (the inputs are f32, and TF32 would change the numbers),
// TMA, or compacting the hits of a tap before the product (a tile with one
// hit still multiplies TM rows; the bound counts hits only).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // input channels per shared-memory stage
constexpr int kThreads = 256;

template <int TN>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ f, const int32_t* __restrict__ idx,
              const float* __restrict__ w, int v, int c, int k_taps, int q, int co,
              float* __restrict__ out) {
  constexpr int kTx = TN / 4;           // threads across the output channels
  constexpr int TM = 4 * kThreads / kTx;  // target rows per block
  __shared__ int s_idx[TM];
  __shared__ float s_g[kChunk][TM + 1];
  __shared__ float s_w[kChunk][TN];

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int t = threadIdx.x;
  const int ty = t / kTx;  // rows ty*4 .. ty*4+3
  const int tx = t % kTx;  // cols tx*4 .. tx*4+3
  const float* fb = f + (size_t)b * v * c;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < k_taps; ++k) {
    int any = 0;
    for (int r = t; r < TM; r += kThreads) {
      const int qi = q0 + r;
      int sl = -1;
      if (qi < q) {
        sl = idx[((size_t)b * k_taps + k) * q + qi];
        if (sl >= v) sl = -1;  // out-of-range indices contribute nothing
      }
      s_idx[r] = sl;
      any |= sl >= 0;
    }
    if (!__syncthreads_or(any)) continue;  // no row of this tile hits

    for (int c0 = 0; c0 < c; c0 += kChunk) {
      const int cw = min(kChunk, c - c0);
      for (int e = t; e < TM * cw; e += kThreads) {
        const int r = e / cw;
        const int cc = e - r * cw;
        const int sl = s_idx[r];
        s_g[cc][r] = sl >= 0 ? __ldg(fb + (size_t)sl * c + c0 + cc) : 0.f;
      }
      for (int e = t; e < cw * TN; e += kThreads) {
        const int cc = e / TN;
        const int nn = e % TN;
        s_w[cc][nn] = n0 + nn < co ? __ldg(w + ((size_t)k * c + c0 + cc) * co + n0 + nn) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < cw; ++cc) {
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

template <int TN>
cudaError_t launch(const float* f, const int32_t* idx, const float* w, int b, int v, int c,
                   int k_taps, int q, int co, float* out, cudaStream_t stream) {
  constexpr int TM = 4 * kThreads / (TN / 4);
  dim3 grid((q + TM - 1) / TM, (co + TN - 1) / TN, b);
  gather_kernel<TN><<<grid, kThreads, 0, stream>>>(f, idx, w, v, c, k_taps, q, co, out);
  return cudaGetLastError();
}

}  // namespace

// f (b, v, c) f32, idx (b, k, q) i32 in [0, v) or -1, w (k, c, co) f32;
// out (b, q, co) f32. The output tile's width follows co.
extern "C" int gather_launch(const void* f, const void* idx, const void* w, int b, int v,
                             int c, int k_taps, int q, int co, void* out, void* stream) {
  if (b <= 0 || v <= 0 || c <= 0 || k_taps <= 0 || q <= 0 || co <= 0)
    return cudaErrorInvalidValue;
  const float* ff = static_cast<const float*>(f);
  const int32_t* ii = static_cast<const int32_t*>(idx);
  const float* ww = static_cast<const float*>(w);
  float* oo = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co <= 16) return launch<16>(ff, ii, ww, b, v, c, k_taps, q, co, oo, s);
  if (co <= 32) return launch<32>(ff, ii, ww, b, v, c, k_taps, q, co, oo, s);
  return launch<64>(ff, ii, ww, b, v, c, k_taps, q, co, oo, s);
}
