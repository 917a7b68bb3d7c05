// K1: furthest point sampling, d-fps and s-fps in one kernel.
//
// Replaces the Pallas TPU kernels `_fps_kernel_batched` and `_fps_kernel`
// (tsm_det_pointcloud_tpu/ops/fps_pallas.py:28, :67). Same function:
//   step i: mindist = min(mindist, (dx*dx + dy*dy) + dz*dz)   (valid lanes)
//           key     = weighted ? w * mindist : mindist,  invalid lanes -1
//           pick    = first argmax(key)
// with the seed pick at index 0.
//
// Bound: the sampling loop is sequential in the pick index; each step reads
// the whole row once, so one block owns one batch row. The row's xyz lives
// in shared memory (SoA, up to 16384 points = 192 KB) and each thread keeps
// its strided slice of mindist (and the weights) in registers, so a step
// touches no device memory. Each step ends in a block argmax (warp shuffles
// + one shared-memory stage); ties go to the lowest index, as jnp.argmax.
// Known limit: one block per row, so a batch of 16 uses 16 of the 132 SMs.
//
// d2 is formed with round-to-nearest intrinsics so that nvcc cannot contract
// it into FMAs: the picks then equal the plain version's bit for bit (a
// changed rounding flips ties, and each flipped pick cascades).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 16;

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int PT, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const float* __restrict__ weights,
           const uint8_t* __restrict__ valid, int n, int npoint,
           int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + n;
  float* sz = smem + 2 * n;
  __shared__ float red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ int sel_shared;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* x = xyz + (size_t)b * n * 3;
  const uint8_t* v = valid ? valid + (size_t)b * n : nullptr;
  int32_t* o = out + (size_t)b * npoint;

  for (int j = t; j < n; j += kThreads) {
    sx[j] = x[3 * j];
    sy[j] = x[3 * j + 1];
    sz[j] = x[3 * j + 2];
  }
  // mindist >= 0 on valid lanes and -1 on invalid lanes for the whole run,
  // so the sign carries the validity mask
  float md[PT];
  float pw[PT];
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int j = t + k * kThreads;
    const bool ok = j < n && (v == nullptr || v[j] != 0);
    md[k] = ok ? 1e10f : -1.f;
    pw[k] = (WEIGHTED && j < n) ? weights[(size_t)b * n + j] : 0.f;
  }
  if (t == 0) o[0] = 0;
  __syncthreads();

  int sel = 0;
  for (int step = 1; step < npoint; ++step) {
    const float qx = sx[sel], qy = sy[sel], qz = sz[sel];
    float best = __int_as_float(0xff800000);  // -inf
    int best_i = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int j = t + k * kThreads;
      if (j < n) {
        const float dx = __fsub_rn(sx[j], qx);
        const float dy = __fsub_rn(sy[j], qy);
        const float dz = __fsub_rn(sz[j], qz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        float key;
        if (md[k] >= 0.f) {
          md[k] = fminf(md[k], d2);
          key = WEIGHTED ? __fmul_rn(pw[k], md[k]) : md[k];
        } else {
          key = -1.f;
        }
        // j ascends within a thread: strict > keeps the first max
        if (key > best) {
          best = key;
          best_i = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      take_better(best, best_i, ov, oi);
    }
    if ((t & 31) == 0) {
      red_val[t >> 5] = best;
      red_idx[t >> 5] = best_i;
    }
    __syncthreads();
    if (t < 32) {
      best = red_val[t];
      best_i = red_idx[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        take_better(best, best_i, ov, oi);
      }
      if (t == 0) {
        sel_shared = best_i;
        o[step] = best_i;
      }
    }
    __syncthreads();
    sel = sel_shared;
  }
}

template <int PT, bool WEIGHTED>
cudaError_t launch(const float* xyz, const float* weights, const uint8_t* valid,
                   int b, int n, int npoint, int32_t* out, cudaStream_t stream) {
  const size_t smem = (size_t)n * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PT, WEIGHTED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PT, WEIGHTED><<<b, kThreads, smem, stream>>>(xyz, weights, valid, n,
                                                          npoint, out);
  return cudaGetLastError();
}

template <bool WEIGHTED>
cudaError_t dispatch(const float* xyz, const float* weights, const uint8_t* valid,
                     int b, int n, int npoint, int32_t* out, cudaStream_t stream) {
  const int pt = (n + kThreads - 1) / kThreads;
  if (pt <= 1) return launch<1, WEIGHTED>(xyz, weights, valid, b, n, npoint, out, stream);
  if (pt <= 2) return launch<2, WEIGHTED>(xyz, weights, valid, b, n, npoint, out, stream);
  if (pt <= 4) return launch<4, WEIGHTED>(xyz, weights, valid, b, n, npoint, out, stream);
  if (pt <= 8) return launch<8, WEIGHTED>(xyz, weights, valid, b, n, npoint, out, stream);
  if (pt <= kMaxPerThread)
    return launch<kMaxPerThread, WEIGHTED>(xyz, weights, valid, b, n, npoint, out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// xyz (b, n, 3) f32, weights (b, n) f32 or null (d-fps), valid (b, n) u8 or
// null, out (b, npoint) i32. n <= 16384. Returns the launch's cudaError_t.
extern "C" int fps_launch(const void* xyz, const void* weights, const void* valid,
                          int b, int n, int npoint, void* out, void* stream) {
  if (n <= 0 || n > kThreads * kMaxPerThread || npoint <= 0) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xyz);
  const float* w = static_cast<const float*>(weights);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != nullptr) return dispatch<true>(x, w, v, b, n, npoint, o, s);
  return dispatch<false>(x, w, v, b, n, npoint, o, s);
}
