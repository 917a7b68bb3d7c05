// The per-step exchange of FPS on a thread-block cluster, shared by K1
// (csrc/fps.cu) and K6 (csrc/fps_block.cu). A cluster of CL CTAs runs one
// scan; each of its NC warps reduces its own points to one candidate pick
// (max key, least original index, the point's x, y, z) and pushes it into
// every CTA's shared memory with st.async, which completes bytes on that
// CTA's mbarrier; each warp waits on its own CTA's mbarrier for all NC
// candidates and reduces them in the same order, so every warp of the
// cluster agrees on the pick without a CTA or cluster barrier. Slots and
// mbarriers alternate by step parity: a warp can push step s + 2's candidate
// only after every warp has pushed step s + 1's, that is, after every warp
// has read step s's. Warp reductions use redux.sync on the order-preserving
// bits of the value, and on the index only when values tie, so ties go to the
// least index in every reduction. A cluster's CTAs are resident together, so
// every candidate arrives unless the kernel is wrong; a bounded spin then
// fails the launch (__trap, a CUDA error at the caller's next check) instead
// of hanging the card or handing on a wrong pick.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace fpsx {

constexpr int kSlot = 8;                     // floats a candidate slot
constexpr int kSlotBytes = 5 * 4;            // bytes st.async writes a slot
constexpr long long kSpinLimit = 1ll << 20;  // try_waits before the launch fails
constexpr unsigned kFull = 0xffffffffu;

// a candidate pick: its key, original index and coordinates
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

// ((dx*dx + dy*dy) + dz*dz), each operation rounded to nearest: nvcc cannot
// contract it into FMAs, so it equals the plain PyTorch version bit for bit
__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// the float's order as an unsigned integer (no NaN here; keys are never -0)
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

// expect a step's NC candidates: one arrival and their bytes
template <int NC>
__device__ __forceinline__ void arm(uint64_t* mbar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(mbar)),
               "r"(NC * kSlotBytes)
               : "memory");
}

// wait for the mbarrier's phase of this parity; after kSpinLimit tries the
// launch fails
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
template <int CL>
__device__ __forceinline__ void push(const Cand& c, float* s_slots, uint64_t* mbar, int slot,
                                     int lane) {
  if (lane < CL) {
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

// the NC candidates of a step, reduced in the same order by every warp
template <int NC>
__device__ __forceinline__ Cand gather_best(const float* s_slots, int lane) {
  Cand c = none();
#pragma unroll
  for (int k = lane; k < NC; k += 32) {
    const float4 a = *reinterpret_cast<const float4*>(s_slots + k * kSlot);
    take_better(c, Cand{a.x, __float_as_int(a.y), a.z, a.w, s_slots[k * kSlot + 4]});
  }
  return warp_best(c);
}

// a step's exchange: push, wait, reduce; returns the step's pick. s_slots
// (2, NC * kSlot) and s_mbar (2,) in this CTA's shared memory; gwarp is the
// warp's rank in the cluster, t the thread's in its CTA.
template <int CL, int NC>
__device__ __forceinline__ Cand exchange(const Cand& mine, int step, float (*s_slots)[NC * kSlot],
                                         uint64_t* s_mbar, int gwarp, int t) {
  const int par = step & 1;
  const int lane = t & 31;
  push<CL>(mine, s_slots[par], s_mbar + par, gwarp, lane);
  wait_phase(s_mbar + par, ((step - 1) >> 1) & 1);
  // re-arm this parity for step + 2: every push of that step comes after
  // every warp's push of step + 1, and this thread pushes step + 1 later
  if (t == 0) arm<NC>(s_mbar + par);
  return gather_best<NC>(s_slots[par], lane);
}

template <int NC>
__device__ __forceinline__ void init_exchange(uint64_t* s_mbar, int t) {
  if (t == 0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(s_mbar + p)));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    arm<NC>(s_mbar);
    arm<NC>(s_mbar + 1);
  }
}

// One step's exchange and nothing else, `rounds` times: the latency floor of
// a step on this cluster layout. sink (clusters * CL,) f32.
template <int CL, int NC, int THREADS>
__global__ void __launch_bounds__(THREADS) round_kernel(int rounds, float* __restrict__ sink) {
  __shared__ __align__(16) float s_slots[2][NC * kSlot];
  __shared__ __align__(8) uint64_t s_mbar[2];
  const int t = threadIdx.x;
  const int gwarp = (int)cluster_rank() * (THREADS / 32) + (t >> 5);
  init_exchange<NC>(s_mbar, t);
  cluster_sync();
  float acc = 0.f;
  for (int step = 1; step <= rounds; ++step) {
    acc += exchange<CL, NC>(Cand{acc + gwarp, gwarp, acc, 0.f, 0.f}, step, s_slots, s_mbar, gwarp,
                            t)
               .x;
  }
  if (t == 0) sink[blockIdx.x] = acc;
  cluster_sync();
}

// a launch of `clusters` clusters of CL CTAs of `threads` threads; a
// cluster of more than 8 CTAs is non-portable and must be allowed first
inline cudaError_t cluster_config(const void* kernel, int cl, int clusters, int threads, int smem,
                                  cudaStream_t stream, cudaLaunchConfig_t& cfg,
                                  cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  if (cl > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * cl);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace fpsx
