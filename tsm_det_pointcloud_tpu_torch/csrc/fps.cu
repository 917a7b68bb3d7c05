// K1: furthest point sampling, d-fps and s-fps in one kernel.
//
// Replaces the Pallas TPU kernels `_fps_kernel_batched` and `_fps_kernel`
// (tsm_det_pointcloud_tpu/ops/fps_pallas.py:28, :67). Same function:
//   step i: mindist = min(mindist, (dx*dx + dy*dy) + dz*dz)   (valid lanes)
//           key     = weighted ? w * mindist : mindist,  invalid lanes -1
//           pick    = first argmax(key)
// with the seed pick at index 0. d2 is formed with round-to-nearest
// intrinsics so that nvcc cannot contract it into FMAs: the picks then equal
// the plain version's bit for bit (a changed rounding flips ties, and each
// flipped pick cascades).
//
// Bound: the chain of npoint - 1 dependent steps; a step's work (9 or 10
// operations a point) is small beside its latency, so the yardstick is a
// latency floor: the steps times one exchange round of the cluster layout
// (`fps_round_probe`, timed alone by chip_smoke.py).
//
// Design: one row runs on a cluster of CL CTAs of 8 warps: 4 CTAs for rows
// of up to 4096 points (a lane holds at most 4), else 8. Each warp owns
// a fixed slice of the row, 32 * PT points, and each lane PT of them (8 at
// 16384 points on a cluster of 8) with their coordinates, running mindist
// and weights in registers; the sign of mindist carries the validity mask
// (-1 on invalid points). A step computes the lane's d2 and keys without a
// branch, makes one warp reduction to the warp's candidate (key, least
// index, x, y, z), and the cluster agrees on the pick by
// csrc/cluster_exchange.cuh's exchange (st.async pushes onto every CTA's
// mbarrier, no CTA or cluster barrier). A CTA holds only the exchange's
// slots in shared memory, so many clusters are resident at once and a batch
// of 16 rows runs in one wave (`fps_plan` reports how many; a larger batch
// runs in waves).
#include "cluster_exchange.cuh"

namespace {

using namespace fpsx;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPoints = 16384;

template <int CL, int PT, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const float* __restrict__ weights,
           const uint8_t* __restrict__ valid, int n, int npoint, int32_t* __restrict__ out) {
  constexpr int NC = CL * kWarps;  // candidates a step
  __shared__ __align__(16) float s_slots[2][NC * kSlot];
  __shared__ __align__(8) uint64_t s_mbar[2];

  const int rank = (int)cluster_rank();
  const int b = blockIdx.x / CL;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int gwarp = rank * kWarps + (t >> 5);
  const int j0 = gwarp * 32 * PT + lane;  // this lane's points: j0 + 32 i
  const float* x = xyz + (size_t)b * n * 3;

  float px[PT], py[PT], pz[PT], md[PT], pw[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int j = j0 + 32 * i;
    const bool in = j < n;
    px[i] = in ? x[3 * j] : 0.f;
    py[i] = in ? x[3 * j + 1] : 0.f;
    pz[i] = in ? x[3 * j + 2] : 0.f;
    // mindist >= 0 on valid points and -1 on invalid ones for the whole run;
    // pad lanes (j >= n) hold -1 too, and their index is above every real
    // one's, so they never win a step
    md[i] = in && (valid == nullptr || valid[(size_t)b * n + j] != 0) ? 1e10f : -1.f;
    pw[i] = WEIGHTED && in ? weights[(size_t)b * n + j] : 0.f;
  }
  if (rank == 0 && t == 0) out[(size_t)b * npoint] = 0;
  init_exchange<NC>(s_mbar, t);
  cluster_sync();  // every CTA's mbarriers are armed before the first push

  // every warp of the cluster keeps the last pick; the seed pick is point 0
  float qx = x[0], qy = x[1], qz = x[2];
  for (int step = 1; step < npoint; ++step) {
    // branchless: the lane's best key and which of its points holds it
    // (i ascends with the index: strict > keeps the first maximum); its
    // coordinates are selected once, after the loop
    float bv = __int_as_float(0xff800000);
    int bi = 0;
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const float d2 = sq3(__fsub_rn(px[i], qx), __fsub_rn(py[i], qy), __fsub_rn(pz[i], qz));
      const bool live = md[i] >= 0.f;
      md[i] = live ? fminf(md[i], d2) : md[i];
      const float key = live ? (WEIGHTED ? __fmul_rn(pw[i], md[i]) : md[i]) : -1.f;
      if (key > bv) bv = key, bi = i;
    }
    float bx = px[0], by = py[0], bz = pz[0];
#pragma unroll
    for (int i = 1; i < PT; ++i)
      if (bi == i) bx = px[i], by = py[i], bz = pz[i];
    const Cand best{bv, j0 + 32 * bi, bx, by, bz};
    const Cand pick = exchange<CL, NC>(warp_best(best), step, s_slots, s_mbar, gwarp, t);
    qx = pick.x;
    qy = pick.y;
    qz = pick.z;
    if (rank == 0 && t == 0) out[(size_t)b * npoint + step] = pick.i;
  }
  cluster_sync();  // every push has landed before any CTA leaves
}

// lanes' points: the least power of two that covers n on CL CTAs
int points_a_lane(int cl, int n) {
  const int lanes = cl * kThreads;
  int pt = 1;
  while (pt * lanes < n) pt *= 2;
  return pt;
}

// one instantiation of the kernel: its launch, and how many of its clusters
// are resident at once
template <int CL, int PT, bool W>
struct Fps {
  static cudaError_t config(int rows, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                            cudaLaunchAttribute& attr) {
    return cluster_config(reinterpret_cast<const void*>(fps_kernel<CL, PT, W>), CL, rows,
                          kThreads, 0, stream, cfg, attr);
  }

  static cudaError_t active(int& out) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = config(1, nullptr, cfg, attr);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(&out, fps_kernel<CL, PT, W>, &cfg);
  }

  static cudaError_t launch(const float* xyz, const float* weights, const uint8_t* valid, int b,
                            int n, int npoint, int32_t* out, cudaStream_t stream) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = config(b, stream, cfg, attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, fps_kernel<CL, PT, W>, xyz, weights, valid, n, npoint, out);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

// the cluster size a row of n points runs on: on an H100 clusters of 4 took
// less time a step than clusters of 8 at 4096 points, and more at 16384
int cluster_size(int n) { return n <= 4096 ? 4 : 8; }

// f(Fps<CL, PT, W>{}) for the layout of rows of n points: a cluster of 4
// with 1, 2 or 4 points a lane, or a cluster of 8 with 4 or 8
template <bool W, class F>
cudaError_t by_layout(int n, F f) {
  if (cluster_size(n) == 4) {
    switch (points_a_lane(4, n)) {
      case 1: return f(Fps<4, 1, W>{});
      case 2: return f(Fps<4, 2, W>{});
      case 4: return f(Fps<4, 4, W>{});
    }
  } else {
    switch (points_a_lane(8, n)) {
      case 4: return f(Fps<8, 4, W>{});
      case 8: return f(Fps<8, 8, W>{});
    }
  }
  return cudaErrorInvalidValue;
}

template <class F>
cudaError_t with_fps(bool w, int n, F f) {
  return w ? by_layout<true>(n, f) : by_layout<false>(n, f);
}

int slots_smem(int cl) { return 2 * cl * kWarps * kSlot * (int)sizeof(float); }

}  // namespace

// The plan for rows of n points: out3 = cluster size, the most clusters of
// that layout resident at once (cudaOccupancyMaxActiveClusters), shared
// memory bytes of a CTA's exchange slots.
extern "C" int fps_plan(int n, int weighted, void* out3) {
  if (n <= 0 || n > kMaxPoints) return cudaErrorInvalidValue;
  int act = 0;
  cudaError_t err = with_fps(weighted != 0, n, [&](auto k) { return k.active(act); });
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out3);
  o[0] = cluster_size(n);
  o[1] = act;
  o[2] = slots_smem(cluster_size(n));
  return cudaSuccess;
}

// xyz (b, n, 3) f32, weights (b, n) f32 or null (d-fps), valid (b, n) u8 or
// null, out (b, npoint) i32. n <= 16384. Returns the launch's cudaError_t.
extern "C" int fps_launch(const void* xyz, const void* weights, const void* valid, int b, int n,
                          int npoint, void* out, void* stream) {
  if (b <= 0 || n <= 0 || n > kMaxPoints || npoint <= 0) return cudaErrorInvalidValue;
  return with_fps(weights != nullptr, n, [&](auto k) {
    return k.launch(static_cast<const float*>(xyz), static_cast<const float*>(weights),
                    static_cast<const uint8_t*>(valid), b, n, npoint, static_cast<int32_t*>(out),
                    static_cast<cudaStream_t>(stream));
  });
}

// `clusters` clusters of `cl` CTAs (4 or 8) run `rounds` exchange rounds of
// K1's layout; sink (clusters * cl,) f32. For timing the floor of a K1 step.
extern "C" int fps_round_probe(int cl, int clusters, int rounds, void* sink, void* stream) {
  if ((cl != 4 && cl != 8) || clusters <= 0 || rounds <= 0) return cudaErrorInvalidValue;
  const auto k8 = round_kernel<8, 8 * kWarps, kThreads>;
  const auto k4 = round_kernel<4, 4 * kWarps, kThreads>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(cl == 8 ? reinterpret_cast<const void*>(k8)
                                           : reinterpret_cast<const void*>(k4),
                                   cl, clusters, kThreads, 0, static_cast<cudaStream_t>(stream),
                                   cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, cl == 8 ? k8 : k4, rounds, static_cast<float*>(sink));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
