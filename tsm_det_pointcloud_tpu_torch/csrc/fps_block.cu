// K6: block-pruned exact d-fps for rows of more than 16384 points.
//
// Replaces the three Pallas TPU kernels `_fps_block_kernel`,
// `_fps_block_kernel_2row` and `_fps_block_kernel_nrow`
// (tsm_det_pointcloud_tpu/ops/fps_pallas.py:197, :490, :633). They compute one
// function and differ only in how many batch rows share one TPU instruction
// stream; on a card whose blocks run in parallel one kernel stands for all.
// Same function as K1's d-fps (csrc/fps.cu), index for index:
//   step i: mind = min(mind, (dx*dx + dy*dy) + dz*dz)   on valid points
//           pick = the first maximum of mind in the ORIGINAL order
// with the seed pick at index 0 and invalid points pinned at -1.
//
// The points arrive Morton-sorted in blocks of 1024 (ops/sampling.py
// `block_prep`): SoA x, y, z, original index and mind in device memory, and
// per block its bounding box over valid points, the maximum of its mind and
// the least original index that attains it. mind only falls, and a point of
// a block is at least gap(bbox, q) from q, so a step updates only the blocks
// with gap^2 < block max; the rest cannot change. gap^2 and d2 are formed
// with the same round-to-nearest intrinsics in the same association, so no
// FMA contraction can put a point's d2 below its block's gap^2: rounding is
// monotone, and the skip stays sound in floating point. Ties go to the least
// original index inside a block and again across blocks; the Morton order
// never decides.
//
// Bound: the sequential loop over the picks. The work of a step is the
// visited blocks' points (9 operations and 24 bytes each, from L2: a scan's
// state is about 2.4 MB at 122880 points, too large for one block's shared
// memory, which is why K1 stops at 16384); the time of a step is latency:
// two block-wide barriers and one round of L2 loads. One thread block owns
// one scan. Warp 0 picks, tests the gaps and compacts the active list; then
// each warp takes quarters of active Morton blocks (8 points a lane, all
// their 16-byte loads in flight at once, a shuffle reduction, no barrier
// inside), and warp 0 joins the quarters. The reduction carries the winning
// point's coordinates beside (max, least index), so the next step starts
// without a dependent load of the pick from device memory. A batch of 8
// uses 8 of the 132 SMs; spreading one scan over a thread-block cluster with
// mind in distributed shared memory is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 1024;      // points per Morton block
constexpr int kSplit = 4;         // warps' shares of one Morton block
constexpr int kShare = kBlock / kSplit;
constexpr int kMaxBlocks = 1024;  // 32 words of shared memory a block
constexpr int kWordsPerBlock = 12 + 5 * kSplit;
constexpr unsigned kFull = 0xffffffffu;

// a candidate pick: its min-distance, original index and coordinates
struct Cand {
  float v;
  int i;
  float x, y, z;
};

__device__ __forceinline__ void take_better(Cand& a, const Cand& o) {
  if (o.v > a.v || (o.v == a.v && o.i < a.i)) a = o;
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.v = __shfl_xor_sync(kFull, c.v, off);
    o.i = __shfl_xor_sync(kFull, c.i, off);
    o.x = __shfl_xor_sync(kFull, c.x, off);
    o.y = __shfl_xor_sync(kFull, c.y, off);
    o.z = __shfl_xor_sync(kFull, c.z, off);
    take_better(c, o);
  }
  return c;  // the same in every lane: the order of (max, least index) is total
}

__device__ __forceinline__ float gap(float lo, float hi, float q) {
  return fmaxf(fmaxf(__fsub_rn(lo, q), __fsub_rn(q, hi)), 0.f);
}

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ void visit(float x, float y, float z, int oi, float& m,
                                      float qx, float qy, float qz, Cand& best) {
  // valid points hold mind >= 0; invalid (-1) and pad (-2) lanes stay pinned
  if (m >= 0.f)
    m = fminf(m, sq3(__fsub_rn(x, qx), __fsub_rn(y, qy), __fsub_rn(z, qz)));
  take_better(best, Cand{m, oi, x, y, z});
}

__global__ void __launch_bounds__(kThreads)
fps_block_kernel(const float* __restrict__ xyz, const float* __restrict__ xs,
                 const float* __restrict__ ys, const float* __restrict__ zs,
                 const int32_t* __restrict__ ois, float* __restrict__ mind,
                 const float* __restrict__ bbox, const float* __restrict__ bmax0,
                 const int32_t* __restrict__ barg0, int n, int nb, int npoint,
                 int32_t* __restrict__ out, long long* __restrict__ visits) {
  extern __shared__ float smem[];
  float* s_box = smem;                                   // (6, nb)
  float* s_bmax = smem + 6 * nb;                         // (nb,) block max of mind
  int* s_barg = reinterpret_cast<int*>(smem + 7 * nb);   // (nb,) its least index
  float* s_bxyz = smem + 8 * nb;                         // (3, nb) that point
  int* s_act = reinterpret_cast<int*>(smem + 11 * nb);   // (nb,) active list
  float* s_pv = smem + 12 * nb;                          // (kSplit * nb,) shares' results
  int* s_pi = reinterpret_cast<int*>(s_pv + kSplit * nb);
  float* s_pxyz = s_pv + 2 * kSplit * nb;                // (3, kSplit * nb)
  __shared__ int s_nact;
  __shared__ float s_q[3];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const size_t row = (size_t)b * nb * kBlock;
  xyz += (size_t)b * n * 3;
  xs += row;
  ys += row;
  zs += row;
  ois += row;
  mind += row;
  out += (size_t)b * npoint;

  for (int j = t; j < 6 * nb; j += kThreads) s_box[j] = bbox[(size_t)b * 6 * nb + j];
  for (int j = t; j < nb; j += kThreads) {
    const int arg = barg0[(size_t)b * nb + j];  // a real point: no block is all pad
    s_bmax[j] = bmax0[(size_t)b * nb + j];
    s_barg[j] = arg;
    s_bxyz[j] = xyz[3 * arg];
    s_bxyz[nb + j] = xyz[3 * arg + 1];
    s_bxyz[2 * nb + j] = xyz[3 * arg + 2];
  }
  if (t == 0) out[0] = 0;
  __syncthreads();

  // warp 0 keeps the last pick's coordinates; the seed pick is point 0
  float px = xyz[0], py = xyz[1], pz = xyz[2];
  long long n_visits = 0;  // lane 0 of warp 0 keeps it
  for (int step = 1; step < npoint; ++step) {
    if (warp == 0) {
      int n_act = 0;
      for (int g0 = 0; g0 < nb; g0 += 32) {
        const int g = g0 + lane;
        bool act = false;
        if (g < nb) {
          const float g2 = sq3(gap(s_box[g], s_box[nb + g], px),
                               gap(s_box[2 * nb + g], s_box[3 * nb + g], py),
                               gap(s_box[4 * nb + g], s_box[5 * nb + g], pz));
          act = g2 < s_bmax[g];
        }
        const unsigned m = __ballot_sync(kFull, act);
        if (act) s_act[n_act + __popc(m & ((1u << lane) - 1u))] = g;
        n_act += __popc(m);
      }
      if (lane == 0) {
        s_nact = n_act;
        s_q[0] = px;
        s_q[1] = py;
        s_q[2] = pz;
        n_visits += n_act;
      }
    }
    __syncthreads();
    const int n_act = s_nact;
    const float qx = s_q[0], qy = s_q[1], qz = s_q[2];
    for (int item = warp; item < kSplit * n_act; item += kWarps) {
      const int g = s_act[item / kSplit];
      const size_t base = (size_t)g * kBlock + (item % kSplit) * kShare + lane * 4;
      Cand best{__int_as_float(0xff800000), 0x7fffffff, 0.f, 0.f, 0.f};  // -inf
#pragma unroll
      for (int k = 0; k < kShare / 128; ++k) {
        const size_t p = base + k * 128;
        const float4 x = *reinterpret_cast<const float4*>(xs + p);
        const float4 y = *reinterpret_cast<const float4*>(ys + p);
        const float4 z = *reinterpret_cast<const float4*>(zs + p);
        const int4 oi = *reinterpret_cast<const int4*>(ois + p);
        float4 m = *reinterpret_cast<float4*>(mind + p);
        visit(x.x, y.x, z.x, oi.x, m.x, qx, qy, qz, best);
        visit(x.y, y.y, z.y, oi.y, m.y, qx, qy, qz, best);
        visit(x.z, y.z, z.z, oi.z, m.z, qx, qy, qz, best);
        visit(x.w, y.w, z.w, oi.w, m.w, qx, qy, qz, best);
        *reinterpret_cast<float4*>(mind + p) = m;
      }
      best = warp_best(best);
      if (lane == 0) {
        s_pv[item] = best.v;
        s_pi[item] = best.i;
        s_pxyz[item] = best.x;
        s_pxyz[kSplit * nb + item] = best.y;
        s_pxyz[2 * kSplit * nb + item] = best.z;
      }
    }
    __syncthreads();
    if (warp == 0) {
      // join the shares of each visited block
      for (int a = lane; a < n_act; a += 32) {
        Cand c{s_pv[kSplit * a], s_pi[kSplit * a], s_pxyz[kSplit * a],
               s_pxyz[kSplit * nb + kSplit * a], s_pxyz[2 * kSplit * nb + kSplit * a]};
#pragma unroll
        for (int q = 1; q < kSplit; ++q) {
          const int it = kSplit * a + q;
          take_better(c, Cand{s_pv[it], s_pi[it], s_pxyz[it], s_pxyz[kSplit * nb + it],
                              s_pxyz[2 * kSplit * nb + it]});
        }
        const int g = s_act[a];
        s_bmax[g] = c.v;
        s_barg[g] = c.i;
        s_bxyz[g] = c.x;
        s_bxyz[nb + g] = c.y;
        s_bxyz[2 * nb + g] = c.z;
      }
      __syncwarp();
      Cand best{__int_as_float(0xff800000), 0x7fffffff, 0.f, 0.f, 0.f};
      for (int g = lane; g < nb; g += 32)
        take_better(best, Cand{s_bmax[g], s_barg[g], s_bxyz[g], s_bxyz[nb + g],
                               s_bxyz[2 * nb + g]});
      best = warp_best(best);
      px = best.x;
      py = best.y;
      pz = best.z;
      if (lane == 0) out[step] = best.i;
    }
    // warp 0 goes straight on to the next step's gap tests: it alone wrote
    // the per-block state last, and the other warps read s_act / s_q only
    // after the next barrier
  }
  if (t == 0) visits[b] = n_visits;
}

}  // namespace

// xyz (b, n, 3) f32 in the original order; xs, ys, zs, mind (b, nb*1024) f32
// and ois (b, nb*1024) i32 in Morton order (mind is updated in place); bbox
// (b, 6, nb) f32; bmax (b, nb) f32; barg (b, nb) i32; out (b, npoint) i32;
// visits (b,) i64. Returns the launch's cudaError_t.
extern "C" int fps_block_launch(const void* xyz, const void* xs, const void* ys,
                                const void* zs, const void* ois, void* mind,
                                const void* bbox, const void* bmax, const void* barg,
                                int b, int n, int nb, int npoint, void* out,
                                void* visits, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || nb <= 0 || nb > kMaxBlocks ||
      (long long)nb * kBlock < n)
    return cudaErrorInvalidValue;
  const int smem = nb * kWordsPerBlock * (int)sizeof(float);
  // the attribute is raised once per device and size, not at every launch
  static int smem_allowed[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || smem > smem_allowed[dev]) {
    err = cudaFuncSetAttribute(fps_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_allowed[dev] = smem;
  }
  fps_block_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<const float*>(zs),
      static_cast<const int32_t*>(ois), static_cast<float*>(mind),
      static_cast<const float*>(bbox), static_cast<const float*>(bmax),
      static_cast<const int32_t*>(barg), n, nb, npoint, static_cast<int32_t*>(out),
      static_cast<long long*>(visits));
  return cudaGetLastError();
}
