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
// and reduces its candidate (max, least index, x, y, z), then pushes it
// into every CTA's shared memory with st.async, which completes bytes on
// that CTA's mbarrier; each warp waits on its own CTA's mbarrier for all 64
// candidates and reduces them in the same order, so every warp of the
// cluster agrees on the pick. Slots and mbarriers alternate by step parity:
// a warp can push step s + 2's candidate only after every warp has pushed
// step s + 1's, that is, after every warp has read step s's. Warp reductions
// use redux.sync on the order-preserving bits of the value, and on the
// index only when values tie.
//
// Cluster size 8: 16 or 12 CTAs a cluster would fit a scan's state in fewer
// SMs' shared memory, but cudaOccupancyMaxActiveClusters gives 7 resident
// clusters of 16 or of 12 on an H100, so a batch of 8 would run in two
// waves; at 8, `plan` reports how many clusters are resident (a larger
// batch runs in waves, exactly). The layout caps a row at 16 blocks a warp:
// 16 * 64 * 128 = 131072 points.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;                     // CTAs a cluster
constexpr int kClusterWarps = kCluster * kWarps;  // 64 candidates a step
constexpr int kBlock = 128;                     // points per Morton block
constexpr int kPer = kBlock / 32;               // points a lane of each block
constexpr int kMaxLocal = 16;                   // blocks a warp
constexpr int kSlot = 8;                        // floats a candidate slot
constexpr int kSlotBytes = 5 * 4;               // bytes st.async writes a slot
constexpr long long kSpinLimit = 1ll << 20;     // try_waits before the launch fails
constexpr unsigned kFull = 0xffffffffu;

// a candidate pick: its min-distance, original index and coordinates
struct Cand {
  float v;
  int i;
  float x, y, z;
};

__device__ __forceinline__ Cand none() {
  return Cand{__int_as_float(0xff800000), 0x7fffffff, 0.f, 0.f, 0.f};  // -inf
}

__device__ __forceinline__ void take_better(Cand& a, const Cand& o) {
  if (o.v > a.v || (o.v == a.v && o.i < a.i)) a = o;
}

// the float's order as an unsigned integer (no NaN here; mind is never -0)
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (max value, least index) over the warp, in every lane
__device__ __forceinline__ Cand warp_best(const Cand& c) {
  const unsigned key = ordered(c.v);
  const unsigned kmax = __reduce_max_sync(kFull, key);
  const unsigned tied = __ballot_sync(kFull, key == kmax);
  int src = __ffs(tied) - 1;
  if (tied & (tied - 1)) {  // more than one lane holds the maximum: the least index wins
    const unsigned imin = __reduce_min_sync(kFull, key == kmax ? (unsigned)c.i : 0xffffffffu);
    src = __ffs(__ballot_sync(kFull, key == kmax && (unsigned)c.i == imin)) - 1;
  }
  return Cand{__shfl_sync(kFull, c.v, src), __shfl_sync(kFull, c.i, src),
              __shfl_sync(kFull, c.x, src), __shfl_sync(kFull, c.y, src),
              __shfl_sync(kFull, c.z, src)};
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// expect this step's candidates: one arrival and their bytes
__device__ __forceinline__ void arm(uint64_t* mbar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(mbar)),
               "r"(kClusterWarps * kSlotBytes)
               : "memory");
}

// wait for the mbarrier's phase of this parity. A cluster's CTAs are
// resident together, so every candidate arrives unless the kernel is wrong;
// after kSpinLimit tries the launch fails (__trap, an error at the caller's
// next check) rather than hang the card or hand on a wrong pick.
__device__ __forceinline__ void wait_phase(uint64_t* mbar, unsigned parity) {
  const uint32_t addr = smem_u32(mbar);
  for (long long spin = 0; spin < kSpinLimit; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// this warp's candidate into slot `slot` of every CTA (lane r writes CTA r's)
__device__ __forceinline__ void push(const Cand& c, float* s_slots, uint64_t* mbar, int slot,
                                     int lane) {
  if (lane < kCluster) {
    uint32_t dst, bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(dst)
                 : "r"(smem_u32(s_slots + slot * kSlot)), "r"(lane));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(bar) : "r"(smem_u32(mbar)), "r"(lane));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
        "[%5];\n" ::"r"(dst),
        "r"(__float_as_uint(c.v)), "r"((unsigned)c.i), "r"(__float_as_uint(c.x)),
        "r"(__float_as_uint(c.y)), "r"(bar)
        : "memory");
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
            dst + 16),
        "r"(__float_as_uint(c.z)), "r"(bar)
        : "memory");
  }
}

// the 64 candidates of a step, reduced in the same order by every warp
__device__ __forceinline__ Cand gather_best(const float* s_slots, int lane) {
  Cand c = none();
#pragma unroll
  for (int k = lane; k < kClusterWarps; k += 32) {
    const float4 a = *reinterpret_cast<const float4*>(s_slots + k * kSlot);
    take_better(c, Cand{a.x, __float_as_int(a.y), a.z, a.w, s_slots[k * kSlot + 4]});
  }
  return warp_best(c);
}

// a step's exchange, shared by the kernel and the round probe: push, wait,
// reduce; returns the step's pick
__device__ __forceinline__ Cand exchange(const Cand& mine, int step, float (*s_slots)[kClusterWarps * kSlot],
                                         uint64_t* s_mbar, int gwarp, int t) {
  const int par = step & 1;
  const int lane = t & 31;
  push(mine, s_slots[par], s_mbar + par, gwarp, lane);
  wait_phase(s_mbar + par, ((step - 1) >> 1) & 1);
  // re-arm this parity for step + 2: every push of that step comes after
  // every warp's push of step + 1, and this thread pushes step + 1 later
  if (t == 0) arm(s_mbar + par);
  return gather_best(s_slots[par], lane);
}

__device__ __forceinline__ void init_exchange(uint64_t* s_mbar, int t) {
  if (t == 0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(s_mbar + p)));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    arm(s_mbar);
    arm(s_mbar + 1);
  }
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
  init_exchange(s_mbar, t);
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
    const Cand pick = exchange(mine, step, s_slots, s_mbar, gwarp, t);
    px = pick.x;
    py = pick.y;
    pz = pick.z;
    if (rank == 0 && t == 0) out[(size_t)b * npoint + step] = pick.i;
  }
  if (lane == 0 && n_visits) atomicAdd(visits + b, n_visits);
  cluster_sync();  // every push has landed before any CTA leaves
}

// One step's exchange and nothing else, `rounds` times: the floor of K6's
// step. sink (clusters * 8,) f32.
__global__ void __launch_bounds__(kThreads) cluster_round_kernel(int rounds, float* __restrict__ sink) {
  __shared__ __align__(16) float s_slots[2][kClusterWarps * kSlot];
  __shared__ __align__(8) uint64_t s_mbar[2];
  const int t = threadIdx.x;
  const int gwarp = (int)cluster_rank() * kWarps + (t >> 5);
  init_exchange(s_mbar, t);
  cluster_sync();
  float acc = 0.f;
  for (int step = 1; step <= rounds; ++step) {
    acc += exchange(Cand{acc + gwarp, gwarp, acc, 0.f, 0.f}, step, s_slots, s_mbar, gwarp, t).x;
  }
  if (t == 0) sink[blockIdx.x] = acc;
  cluster_sync();
}

int coord_smem(int nb) {
  return kWarps * 3 * ((nb + kClusterWarps - 1) / kClusterWarps) * kBlock * (int)sizeof(float);
}

cudaError_t launch_config(const void* kernel, int clusters, int smem, cudaStream_t stream,
                          cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
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

// `clusters` clusters run `rounds` exchange rounds; sink (clusters * 8,) f32.
// For timing the floor of a K6 step.
extern "C" int fps_block_round_probe(int clusters, int rounds, void* sink, void* stream) {
  if (clusters <= 0 || rounds <= 0) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = launch_config(reinterpret_cast<const void*>(cluster_round_kernel), clusters,
                                  0, static_cast<cudaStream_t>(stream), cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, cluster_round_kernel, rounds, static_cast<float*>(sink));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
