// K6: block-pruned exact d-fps for rows of more than 16384 points.
//
// Replaces the three Pallas TPU kernels `_fps_block_kernel`,
// `_fps_block_kernel_2row` and `_fps_block_kernel_nrow`
// (tsm_det_pointcloud_tpu/ops/fps_pallas.py:197, :490, :633; pallas_calls at
// :468 and :447). They compute one function and differ only in how many
// batch rows share one TPU instruction stream; on a card whose blocks run in
// parallel one kernel stands for all. Same function as K1's d-fps
// (csrc/fps.cu), index for index:
//   step i: mind = min(mind, (dx*dx + dy*dy) + dz*dz)   on valid points
//           pick = the first maximum of mind in the ORIGINAL order
// with the seed pick at index 0 and invalid points pinned at -1.
//
// The points arrive Morton-sorted in blocks of 128 (ops/sampling.py
// `block_prep`): SoA x, y, z, original index and the initial mind, and per
// block its bounding box over valid points, the maximum of its mind and the
// least original index that attains it. mind only falls, and a point of a
// block is at least gap(bbox, q) from q, so a step updates only the blocks
// with gap^2 < block max; the rest cannot change. gap^2 and d2 are formed
// with the same round-to-nearest intrinsics in the same association, so no
// FMA contraction can put a point's d2 below its block's gap^2: rounding is
// monotone, and the skip stays sound in floating point. Ties go to the least
// original index inside a block, across blocks and across warps; the Morton
// order never decides.
//
// Bound: the chain of npoint - 1 dependent steps. A step visits a few
// percent of the blocks (chip_smoke.py prints the share), so its work is
// small and its time is latency. Design: one scan runs on a cluster of 8
// CTAs of 8 warps. Block g belongs to warp g mod 64 of the cluster
// (interleaved: the visited blocks of a step lie close in Morton order, so
// they spread over the warps), at most 16 a warp. A warp owns its blocks
// alone: their coordinates in its part of shared memory, their running mind
// and original indices in registers (4 points a lane), and their state (box,
// max, its index and coordinates) one block a lane. So a step needs no CTA
// barrier: each warp tests its boxes (a ballot), updates its visited blocks
// and reduces its candidate (max, least index, x, y, z); the cluster then
// agrees on the pick by csrc/cluster_exchange.cuh's exchange (st.async
// pushes onto every CTA's mbarrier, no CTA or cluster barrier).
//
// Cluster size 8: 16 or 12 CTAs a cluster would fit a scan's state in fewer
// SMs' shared memory, but cudaOccupancyMaxActiveClusters gives 7 resident
// clusters of 16 or of 12 on an H100, so a batch of 8 would run in two
// waves; at 8, `plan` reports how many clusters are resident (a larger
// batch runs in waves, exactly). The layout caps a row at 16 blocks a warp:
// 16 * 64 * 128 = 131072 points.
#include "cluster_exchange.cuh"

namespace {

using namespace fpsx;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;                     // CTAs a cluster
constexpr int kClusterWarps = kCluster * kWarps;  // 64 candidates a step
constexpr int kBlock = 128;                     // points per Morton block
constexpr int kPer = kBlock / 32;               // points a lane of each block
constexpr int kMaxLocal = 16;                   // blocks a warp

__device__ __forceinline__ float gap(float lo, float hi, float q) {
  return fmaxf(fmaxf(__fsub_rn(lo, q), __fsub_rn(q, hi)), 0.f);
}

__device__ __forceinline__ void visit(float x, float y, float z, int oi, float& m,
                                      float qx, float qy, float qz, Cand& best) {
  // valid points hold mind >= 0; invalid (-1) and pad (-2) lanes stay pinned
  if (m >= 0.f)
    m = fminf(m, sq3(__fsub_rn(x, qx), __fsub_rn(y, qy), __fsub_rn(z, qz)));
  take_better(best, Cand{m, oi, x, y, z});
}

__global__ void __launch_bounds__(kThreads)
fps_cluster_kernel(const float* __restrict__ xyz, const float* __restrict__ xs,
                   const float* __restrict__ ys, const float* __restrict__ zs,
                   const int32_t* __restrict__ ois, const float* __restrict__ mind0,
                   const float* __restrict__ bbox, const float* __restrict__ bmax0,
                   const int32_t* __restrict__ barg0, int n, int nb, int npoint,
                   int32_t* __restrict__ out, unsigned long long* __restrict__ visits) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) float s_slots[2][kClusterWarps * kSlot];
  __shared__ __align__(8) uint64_t s_mbar[2];

  const int rank = (int)cluster_rank();
  const int b = blockIdx.x / kCluster;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gwarp = rank * kWarps + warp;  // this warp in the cluster
  const int nbw = gwarp < nb ? (nb - gwarp + kClusterWarps - 1) / kClusterWarps : 0;
  const int cap = (nb + kClusterWarps - 1) / kClusterWarps;  // blocks a warp at most
  const size_t row = (size_t)b * nb * kBlock;
  xyz += (size_t)b * n * 3;

  // this warp's coordinates: (cap, 128) each of x, y, z
  float* s_x = smem + (size_t)warp * 3 * cap * kBlock;
  float* s_y = s_x + (size_t)cap * kBlock;
  float* s_z = s_y + (size_t)cap * kBlock;
  float mind[kMaxLocal][kPer];
  int oi[kMaxLocal][kPer];
#pragma unroll
  for (int j = 0; j < kMaxLocal; ++j) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      mind[j][k] = -2.f;
      oi[j][k] = 0x7fffffff;
    }
    if (j < nbw) {
      const size_t src = row + (size_t)(gwarp + j * kClusterWarps) * kBlock + lane * kPer;
      const int dst = j * kBlock + lane * kPer;
      *reinterpret_cast<float4*>(s_x + dst) = *reinterpret_cast<const float4*>(xs + src);
      *reinterpret_cast<float4*>(s_y + dst) = *reinterpret_cast<const float4*>(ys + src);
      *reinterpret_cast<float4*>(s_z + dst) = *reinterpret_cast<const float4*>(zs + src);
      const float4 m = *reinterpret_cast<const float4*>(mind0 + src);
      const int4 o = *reinterpret_cast<const int4*>(ois + src);
      mind[j][0] = m.x, mind[j][1] = m.y, mind[j][2] = m.z, mind[j][3] = m.w;
      oi[j][0] = o.x, oi[j][1] = o.y, oi[j][2] = o.z, oi[j][3] = o.w;
    }
  }

  // lane j keeps block j's box, max, its index and point
  float lox = 0.f, hix = 0.f, loy = 0.f, hiy = 0.f, loz = 0.f, hiz = 0.f;
  Cand blk = none();
  if (lane < nbw) {
    const int gb = gwarp + lane * kClusterWarps;
    const float* bb = bbox + (size_t)b * 6 * nb + gb;
    lox = bb[0];
    hix = bb[nb];
    loy = bb[2 * nb];
    hiy = bb[3 * nb];
    loz = bb[4 * nb];
    hiz = bb[5 * nb];
    const int arg = barg0[(size_t)b * nb + gb];  // a real point: no block is all pad
    blk = Cand{bmax0[(size_t)b * nb + gb], arg, xyz[3 * arg], xyz[3 * arg + 1],
               xyz[3 * arg + 2]};
  }
  if (rank == 0 && t == 0) out[(size_t)b * npoint] = 0;
  init_exchange<kClusterWarps>(s_mbar, t);
  cluster_sync();  // every CTA's mbarriers are armed before the first push

  // every warp of the cluster keeps the last pick; the seed pick is point 0
  float px = xyz[0], py = xyz[1], pz = xyz[2];
  unsigned long long n_visits = 0;
  for (int step = 1; step < npoint; ++step) {
    bool act = false;
    if (lane < nbw)
      act = sq3(gap(lox, hix, px), gap(loy, hiy, py), gap(loz, hiz, pz)) < blk.v;
    const unsigned vis = __ballot_sync(kFull, act);
    n_visits += __popc(vis);
    // this warp's candidate: the blocks left alone, then the visited ones
    Cand mine = warp_best(act ? none() : blk);
#pragma unroll
    for (int j = 0; j < kMaxLocal; ++j) {
      if (vis >> j & 1u) {
        const int off = j * kBlock + lane * kPer;
        const float4 x = *reinterpret_cast<const float4*>(s_x + off);
        const float4 y = *reinterpret_cast<const float4*>(s_y + off);
        const float4 z = *reinterpret_cast<const float4*>(s_z + off);
        Cand best = none();
        visit(x.x, y.x, z.x, oi[j][0], mind[j][0], px, py, pz, best);
        visit(x.y, y.y, z.y, oi[j][1], mind[j][1], px, py, pz, best);
        visit(x.z, y.z, z.z, oi[j][2], mind[j][2], px, py, pz, best);
        visit(x.w, y.w, z.w, oi[j][3], mind[j][3], px, py, pz, best);
        best = warp_best(best);
        if (lane == j) blk = best;
        take_better(mine, best);
      }
    }
    const Cand pick =
        exchange<kCluster, kClusterWarps>(mine, step, s_slots, s_mbar, gwarp, t);
    px = pick.x;
    py = pick.y;
    pz = pick.z;
    if (rank == 0 && t == 0) out[(size_t)b * npoint + step] = pick.i;
  }
  if (lane == 0 && n_visits) atomicAdd(visits + b, n_visits);
  cluster_sync();  // every push has landed before any CTA leaves
}

int coord_smem(int nb) {
  return kWarps * 3 * ((nb + kClusterWarps - 1) / kClusterWarps) * kBlock * (int)sizeof(float);
}

cudaError_t launch_config(const void* kernel, int clusters, int smem, cudaStream_t stream,
                          cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  return cluster_config(kernel, kCluster, clusters, kThreads, smem, stream, cfg, attr);
}

}  // namespace

// The plan for rows of nb Morton blocks: out3 = cluster size, the most
// clusters resident at once (cudaOccupancyMaxActiveClusters), dynamic
// shared memory bytes a CTA.
extern "C" int fps_block_plan(int nb, void* out3) {
  if (nb <= 0 || nb > kMaxLocal * kClusterWarps) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = launch_config(reinterpret_cast<const void*>(fps_cluster_kernel), 1,
                                  coord_smem(nb), nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, fps_cluster_kernel, &cfg);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out3);
  o[0] = kCluster;
  o[1] = active;
  o[2] = coord_smem(nb);
  return cudaSuccess;
}

// xyz (b, n, 3) f32 in the original order; xs, ys, zs, mind (b, nb*128) f32
// and ois (b, nb*128) i32 in Morton order (mind is read, not written); bbox
// (b, 6, nb) f32; bmax (b, nb) f32; barg (b, nb) i32; out (b, npoint) i32;
// visits (b,) i64, zero on entry. Returns the launch's cudaError_t.
extern "C" int fps_block_launch(const void* xyz, const void* xs, const void* ys,
                                const void* zs, const void* ois, const void* mind,
                                const void* bbox, const void* bmax, const void* barg,
                                int b, int n, int nb, int npoint, void* out,
                                void* visits, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || nb <= 0 || nb > kMaxLocal * kClusterWarps ||
      (long long)nb * kBlock < n)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = launch_config(reinterpret_cast<const void*>(fps_cluster_kernel), b,
                                  coord_smem(nb), static_cast<cudaStream_t>(stream), cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, static_cast<const float*>(xyz),
                           static_cast<const float*>(xs), static_cast<const float*>(ys),
                           static_cast<const float*>(zs), static_cast<const int32_t*>(ois),
                           static_cast<const float*>(mind), static_cast<const float*>(bbox),
                           static_cast<const float*>(bmax), static_cast<const int32_t*>(barg), n,
                           nb, npoint, static_cast<int32_t*>(out),
                           static_cast<unsigned long long*>(visits));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
