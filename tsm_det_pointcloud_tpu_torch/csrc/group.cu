// K2: fused neighbour query + group, nearest-k.
//
// Replaces the Pallas TPU kernel `_kernel` of
// tsm_det_pointcloud_tpu/ops/group_pallas.py:108 (and its opt-in paired
// variant `_kernel_pair`, :274, which computes the same function). For each
// query and each scale s (up to 4, all in one pass over the sources):
//   hit(j) = valid[j] && d2 < max_r2[s] && (!has_min[s] || d2 >= min_r2[s])
//            && (!use_window || |coord_q - coord_j| <= qr[s] per axis)
//   cnt[s] = #hits (exact, uncapped)
//   idx[s] = the ns[s] nearest hits ordered by (d2, j); unfilled slots
//            repeat the first hit, or 0 when there is none
//   grouped[s][slot] = payload[idx[s][slot]]   (xyz and features, exact f32)
// d2 is the expanded form max((q.q + x.x) - 2 q.x, 0), written with
// round-to-nearest intrinsics so that no FMA contraction changes a hit at a
// radius boundary against the plain version. The Pallas kernel returns the
// first k in Morton order instead; nearest-k is the CPU reference's choice
// and lets the kernel be checked exactly.
//
// Bound: the (queries x sources) distance tests — operations, not bytes.
// One warp owns one query; a block of 8 warps stages tiles of 256 sources
// (xyz, |x|^2, valid, voxel coords) through shared memory. Each lane tests
// one source per sub-step; the per-scale top-k list lives one entry per
// lane in registers and candidates that beat the current k-th are inserted
// in ascending source order, so ties in d2 keep the lower index.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxScales = 4;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kTile = kThreads;
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

struct GroupScales {
  int n_scales;
  int use_window;
  int ns[kMaxScales];
  int offset[kMaxScales];  // first slot of each scale in the slot axis
  int has_min[kMaxScales];
  float min_r2[kMaxScales];
  float max_r2[kMaxScales];
  int qr[kMaxScales][3];
};

namespace {

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kThreads)
query_group_kernel(const float* __restrict__ src_xyz, const uint8_t* __restrict__ src_valid,
                   const int32_t* __restrict__ src_coords, const float* __restrict__ payload,
                   int n, int d, const float* __restrict__ q_xyz,
                   const int32_t* __restrict__ q_coords, int m, GroupScales sc,
                   int total_ns, int32_t* __restrict__ idx_out,
                   int32_t* __restrict__ cnt_out, float* __restrict__ grouped_out) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile], tx2[kTile];
  __shared__ int tvalid[kTile];
  __shared__ int tc[kTile][3];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarpsPerBlock + warp;
  const bool active = qi < m;  // warp-uniform

  float qx = 0.f, qy = 0.f, qz = 0.f, q2 = 0.f;
  int qc0 = 0, qc1 = 0, qc2 = 0;
  if (active) {
    const float* qp = q_xyz + ((size_t)b * m + qi) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
    q2 = sq_norm(qx, qy, qz);
    if (sc.use_window) {
      const int32_t* cp = q_coords + ((size_t)b * m + qi) * 3;
      qc0 = cp[0];
      qc1 = cp[1];
      qc2 = cp[2];
    }
  }

  float lkey[kMaxScales], worst[kMaxScales];
  int lidx[kMaxScales], fill[kMaxScales], hits[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    lkey[s] = __int_as_float(0x7f800000);
    worst[s] = lkey[s];
    lidx[s] = 0;
    fill[s] = 0;
    hits[s] = 0;
  }

  const float* sxyz = src_xyz + (size_t)b * n * 3;
  const uint8_t* svalid = src_valid + (size_t)b * n;
  const int32_t* scoords = sc.use_window ? src_coords + (size_t)b * n * 3 : nullptr;

  for (int base = 0; base < n; base += kTile) {
    __syncthreads();  // the previous tile is consumed
    {
      const int t = threadIdx.x;
      const int j = base + t;
      if (j < n) {
        const float x = sxyz[3 * j], y = sxyz[3 * j + 1], z = sxyz[3 * j + 2];
        tx[t] = x;
        ty[t] = y;
        tz[t] = z;
        tx2[t] = sq_norm(x, y, z);
        tvalid[t] = svalid[j] != 0;
        if (scoords != nullptr) {
          tc[t][0] = scoords[3 * j];
          tc[t][1] = scoords[3 * j + 1];
          tc[t][2] = scoords[3 * j + 2];
        }
      } else {
        tvalid[t] = 0;
      }
    }
    __syncthreads();
    if (!active) continue;
    const int tile_n = min(kTile, n - base);
    for (int s0 = 0; s0 < tile_n; s0 += 32) {
      const int sj = s0 + lane;
      const bool in = sj < tile_n && tvalid[sj] != 0;
      float d2 = 0.f;
      int dc0 = 0, dc1 = 0, dc2 = 0;
      if (in) {
        const float cross = __fadd_rn(
            __fadd_rn(__fmul_rn(qx, tx[sj]), __fmul_rn(qy, ty[sj])), __fmul_rn(qz, tz[sj]));
        d2 = __fsub_rn(__fadd_rn(q2, tx2[sj]), __fmul_rn(2.f, cross));
        d2 = d2 > 0.f ? d2 : 0.f;
        if (sc.use_window) {
          dc0 = abs(qc0 - tc[sj][0]);
          dc1 = abs(qc1 - tc[sj][1]);
          dc2 = abs(qc2 - tc[sj][2]);
        }
      }
#pragma unroll
      for (int s = 0; s < kMaxScales; ++s) {
        if (s >= sc.n_scales) continue;
        const bool hit = in && d2 < sc.max_r2[s] && (!sc.has_min[s] || d2 >= sc.min_r2[s]) &&
                         (!sc.use_window ||
                          (dc0 <= sc.qr[s][0] && dc1 <= sc.qr[s][1] && dc2 <= sc.qr[s][2]));
        hits[s] += __popc(__ballot_sync(kFull, hit));
        const int ns = sc.ns[s];
        unsigned cand = __ballot_sync(kFull, hit && (fill[s] < ns || d2 < worst[s]));
        while (cand) {
          const int src = __ffs(cand) - 1;
          cand &= cand - 1;
          const float cd = __shfl_sync(kFull, d2, src);
          if (fill[s] >= ns && !(cd < worst[s])) continue;
          const int ci = base + s0 + src;
          // entries with an equal d2 hold lower indices and stay ahead
          const int pos = __popc(__ballot_sync(kFull, lane < fill[s] && lkey[s] <= cd));
          const float up_key = __shfl_up_sync(kFull, lkey[s], 1);
          const int up_idx = __shfl_up_sync(kFull, lidx[s], 1);
          if (lane == pos) {
            lkey[s] = cd;
            lidx[s] = ci;
          } else if (lane > pos) {
            lkey[s] = up_key;
            lidx[s] = up_idx;
          }
          if (fill[s] < ns) ++fill[s];
          worst[s] = __shfl_sync(kFull, lkey[s], ns - 1);
        }
      }
    }
  }
  if (!active) return;

  const size_t qrow = (size_t)b * m + qi;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s >= sc.n_scales) continue;
    const int ns = sc.ns[s];
    const int first = fill[s] > 0 ? __shfl_sync(kFull, lidx[s], 0) : 0;
    const int mine = lane < fill[s] ? lidx[s] : first;
    if (lane < ns) idx_out[qrow * total_ns + sc.offset[s] + lane] = mine;
    if (lane == 0) cnt_out[qrow * sc.n_scales + s] = hits[s];
    if (grouped_out != nullptr) {
      for (int l = 0; l < ns; ++l) {
        const int r = __shfl_sync(kFull, mine, l);
        const float* src = payload + ((size_t)b * n + r) * d;
        float* dst = grouped_out + (qrow * total_ns + sc.offset[s] + l) * d;
        for (int c = lane; c < d; c += 32) dst[c] = src[c];
      }
    }
  }
}

}  // namespace

// src_xyz (b, n, 3) f32, src_valid (b, n) u8, src_coords (b, n, 3) i32 or
// null, payload (b, n, d) f32 or null; q_xyz (b, m, 3) f32, q_coords
// (b, m, 3) i32 or null. Outputs: idx (b, m, total_ns) i32, cnt
// (b, m, n_scales) i32, grouped (b, m, total_ns, d) f32 or null.
extern "C" int query_group_launch(const void* src_xyz, const void* src_valid,
                                  const void* src_coords, const void* payload, int b,
                                  int n, int d, const void* q_xyz, const void* q_coords,
                                  int m, GroupScales sc, int total_ns, void* idx_out,
                                  void* cnt_out, void* grouped_out, void* stream) {
  if (sc.n_scales < 1 || sc.n_scales > kMaxScales || n <= 0 || m <= 0 || b <= 0)
    return cudaErrorInvalidValue;
  for (int s = 0; s < sc.n_scales; ++s)
    if (sc.ns[s] < 1 || sc.ns[s] > 32) return cudaErrorInvalidValue;
  if (sc.use_window && (src_coords == nullptr || q_coords == nullptr))
    return cudaErrorInvalidValue;
  dim3 grid((m + kWarpsPerBlock - 1) / kWarpsPerBlock, b);
  query_group_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src_xyz), static_cast<const uint8_t*>(src_valid),
      static_cast<const int32_t*>(src_coords), static_cast<const float*>(payload), n, d,
      static_cast<const float*>(q_xyz), static_cast<const int32_t*>(q_coords), m, sc,
      total_ns, static_cast<int32_t*>(idx_out), static_cast<int32_t*>(cnt_out),
      static_cast<float*>(grouped_out));
  return cudaGetLastError();
}
