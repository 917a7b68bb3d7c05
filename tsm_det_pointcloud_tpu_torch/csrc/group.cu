// K2: fused neighbour query + group, nearest-k, over Morton tiles.
//
// Replaces the Pallas TPU kernel `_kernel` of
// tsm_det_pointcloud_tpu/ops/group_pallas.py:108 (and its opt-in paired
// variant `_kernel_pair`, :274, which computes the same function). For each
// query and each scale s (up to 4, all in one pass over the sources):
//   hit(j) = valid[j] && d2 < max_r2[s] && (!has_min[s] || d2 >= min_r2[s])
//            && (!use_window || |coord_q - coord_j| <= qr[s] per axis)
//   cnt[s] = #hits (exact, uncapped)
//   idx[s] = the ns[s] nearest hits ordered by (d2, original index j);
//            unfilled slots repeat the first hit, or 0 when there is none
//   grouped[s][slot] = payload[idx[s][slot]]   (xyz and features, exact f32)
// d2 is the expanded form max((q.q + x.x) - 2 q.x, 0), written with
// round-to-nearest intrinsics so that no FMA contraction changes a hit at a
// radius boundary against the plain version. The Pallas kernel returns the
// first k in Morton order instead; nearest-k is the CPU reference's choice
// and lets the kernel be checked exactly.
//
// Structure (the Pallas kernel's, group_pallas.py:466-491 and :604-714):
// `grouping.tile_sources` stably sorts each scan's sources by Morton code,
// invalid rows last, into tiles of kTile rows (xyz, |x|^2, original index or
// -1, voxel coords), and keeps per tile the xyz box, the voxel-coordinate box
// and the largest |x|^2 of its valid rows (an all-invalid tile has an empty
// box); K2 calls on the same sources share these tiles. `grouping.query_order`
// Morton-sorts the queries (`qperm`: sorted position -> original row).
// A block of kWarps warps takes kWarps consecutive sorted queries, one warp
// a query, so its query box is compact. It tests every tile's box against
// that box, kThreads tiles a round, and writes the visited ones into a
// shared visit list; only those are staged into shared memory and tested. A
// warp also skips a visited tile out of reach of its own query (the test is
// warp-uniform). Results are written to each query's original row. The
// launch writes, per block, the (query, tile) pairs it tested (`visits`), so
// the bound can be reckoned from the work the rule left. That count is the
// only cost the main path pays for measurement: one word a block, written
// after one more barrier and a kWarps-term sum.
//
// Pruning margin. A tile is visited when gap2 <= thr, with gap2 the squared
// distance between the query box and the tile's box, summed ((x)+(y))+(z)
// with each operation rounded, and
//   thr = r2 + 2^-19 * ((q2max + x2max) + r2)
// where r2 is the largest max_r2 of the call, q2max the largest computed
// |q|^2 of the queries concerned and x2max the tile's largest |x|^2. It is
// conservative. With u = 2^-24 and S = |q|^2 + |x|^2, each of the computed
// |q|^2, |x|^2 and q.x is off by at most 3u times S (three positive terms;
// |q.x| <= S / 2 with the factor 2 of the cross term), the sum q2 + x2
// rounds once (u S) and the difference once (u d2), so the computed
// d2 >= D - 7u S - u D for the true squared distance D. Every source of the
// tile lies at D >= gap^2 (true gap), and the computed gap2, five rounded
// operations on non-negative terms, is at most gap^2 (1 + 6u). So a skipped
// tile (gap2 > thr) has D > thr / (1 + 6u), at least r2 + 25u r2 + 24u S
// (thr holds 32u (S' + r2) with S' = q2max + x2max >= S (1 - 3u), give or
// take O(u^2)), so its computed d2 >= D (1 - u) - 7u S > r2: no source of a
// skipped tile can test d2 < r2, and a skipped tile has no hits. The
// voxel-window test is on exact integers: a tile is skipped when, on some
// axis, its coordinate box lies more than the largest qr from the query
// box's. The margin is tiny beside the radii: 0.04 m^2 at |x| = 75 m. The
// plain version of this rule is `grouping._visit_rule`, with the same
// operations in the same order, so its visit counts equal the kernel's.
//
// Bound: the pair tests of the visited tiles — operations — or the bytes of
// the prepared sources, queries and outputs. One warp owns one query; its
// per-scale top-k list lives in registers, kSlots entries a lane (rank
// 32 h + lane in entry h), and a candidate that beats the k-th by (d2,
// original index) is inserted at its rank by that same order, so the result
// does not depend on the order the sources arrive in. A call whose scales
// all take at most 32 samples runs the one-entry kernel; a call with a
// scale of 33-64 samples (3DSSD's widest balls) runs the two-entry one, in
// which an insertion also moves the entry at rank 31 up into lane 0's
// second entry. Both compute the same function.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxScales = 4;
constexpr int kMaxSlots = 2;     // top-k entries a lane: nsample up to 32 * kMaxSlots
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kThreads;  // one source row a thread when staging
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMarginScale = 1.0f / 524288.0f;  // 2^-19 = 32 u

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

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float axis_gap(float lo, float hi, float qlo, float qhi) {
  return fmaxf(fmaxf(__fsub_rn(lo, qhi), __fsub_rn(qlo, hi)), 0.f);
}

// gap2 <= thr for the query box [qlo, qhi] (|q|^2 up to q2max) and a tile
// box tb = (lo x y z, hi x y z, x2max, -); see the margin above. An empty
// tile's box (lo 1e30, hi -1e30, x2max -1e30) is never within reach
__device__ __forceinline__ bool within_reach(const float* tb, float3 qlo, float3 qhi,
                                             float q2max, float r2) {
  const float gx = axis_gap(tb[0], tb[3], qlo.x, qhi.x);
  const float gy = axis_gap(tb[1], tb[4], qlo.y, qhi.y);
  const float gz = axis_gap(tb[2], tb[5], qlo.z, qhi.z);
  const float gap2 = sq_norm(gx, gy, gz);
  const float thr =
      __fadd_rn(r2, __fmul_rn(kMarginScale, __fadd_rn(__fadd_rn(q2max, tb[6]), r2)));
  return gap2 <= thr;
}

// the tile's coordinate box cb = (lo z y x, hi z y x) within qr of [qclo, qchi]
__device__ __forceinline__ bool within_window(const int* cb, int3 qclo, int3 qchi, int3 qr) {
  return cb[0] - qchi.x <= qr.x && qclo.x - cb[3] <= qr.x && cb[1] - qchi.y <= qr.y &&
         qclo.y - cb[4] <= qr.y && cb[2] - qchi.z <= qr.z && qclo.z - cb[5] <= qr.z;
}

// (d1, i1) before (d2, i2) in the order of the result
__device__ __forceinline__ bool before(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

template <int kSlots>
__global__ void __launch_bounds__(kThreads)
query_group_kernel(const float4* __restrict__ pts, const int32_t* __restrict__ oi,
                   const int4* __restrict__ crd, const float* __restrict__ tbox,
                   const int32_t* __restrict__ cbox, int nt, const float* __restrict__ payload,
                   int n, int d, const float* __restrict__ q_xyz,
                   const int32_t* __restrict__ q_coords, const int32_t* __restrict__ qperm,
                   int m, GroupScales sc, int total_ns, int32_t* __restrict__ idx_out,
                   int32_t* __restrict__ cnt_out, float* __restrict__ grouped_out,
                   int32_t* __restrict__ visits_out) {
  __shared__ float4 sp[kTile];
  __shared__ int soi[kTile];
  __shared__ int4 scrd[kTile];
  __shared__ float stb[8];
  __shared__ int scb[8];
  __shared__ int vis[kThreads];
  __shared__ int wcnt[kWarps];
  __shared__ float4 wq[kWarps];  // each warp's query x, y, z, |q|^2
  __shared__ int3 wqc[kWarps];   // and its voxel coords
  __shared__ int wact[kWarps];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int si = blockIdx.x * kWarps + warp;  // sorted query position
  const bool active = si < m;                 // warp-uniform
  const int qi = active ? qperm[(size_t)b * m + si] : 0;
  const size_t plen = (size_t)nt * kTile;

  float3 q = make_float3(0.f, 0.f, 0.f);
  float q2 = 0.f;
  int3 qc = make_int3(0, 0, 0);
  if (active) {
    const float* qp = q_xyz + ((size_t)b * m + qi) * 3;
    q = make_float3(qp[0], qp[1], qp[2]);
    q2 = sq_norm(q.x, q.y, q.z);
    if (sc.use_window) {
      const int32_t* cp = q_coords + ((size_t)b * m + qi) * 3;
      qc = make_int3(cp[0], cp[1], cp[2]);
    }
  }
  if (lane == 0) {
    wact[warp] = active;
    wq[warp] = make_float4(q.x, q.y, q.z, q2);
    wqc[warp] = qc;
  }

  // the call's reach: the largest radius and query window over the scales
  float r2 = 0.f;
  int3 qrmax = make_int3(INT_MIN, INT_MIN, INT_MIN);
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s >= sc.n_scales) continue;
    r2 = fmaxf(r2, sc.max_r2[s]);
    qrmax = make_int3(max(qrmax.x, sc.qr[s][0]), max(qrmax.y, sc.qr[s][1]),
                      max(qrmax.z, sc.qr[s][2]));
  }
  __syncthreads();

  // the block's query box (its active queries)
  float3 bqlo = make_float3(inf(), inf(), inf()), bqhi = make_float3(-inf(), -inf(), -inf());
  float bq2 = 0.f;
  int3 bclo = make_int3(INT_MAX, INT_MAX, INT_MAX), bchi = make_int3(INT_MIN, INT_MIN, INT_MIN);
  for (int w = 0; w < kWarps; ++w) {
    if (!wact[w]) continue;
    const float4 o = wq[w];
    const int3 oc = wqc[w];
    bqlo = make_float3(fminf(bqlo.x, o.x), fminf(bqlo.y, o.y), fminf(bqlo.z, o.z));
    bqhi = make_float3(fmaxf(bqhi.x, o.x), fmaxf(bqhi.y, o.y), fmaxf(bqhi.z, o.z));
    bq2 = fmaxf(bq2, o.w);
    bclo = make_int3(min(bclo.x, oc.x), min(bclo.y, oc.y), min(bclo.z, oc.z));
    bchi = make_int3(max(bchi.x, oc.x), max(bchi.y, oc.y), max(bchi.z, oc.z));
  }

  // lane l's entry h holds rank 32 h + l of scale s's list
  float lkey[kMaxScales][kSlots], wd[kMaxScales];
  int lidx[kMaxScales][kSlots], wi[kMaxScales], fill[kMaxScales], hits[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
      lkey[s][h] = inf();
      lidx[s][h] = 0;
    }
    wd[s] = inf();
    wi[s] = INT_MAX;
    fill[s] = 0;
    hits[s] = 0;
  }
  int visited = 0;  // tiles this warp tested

  const float* tb_row = tbox + (size_t)b * nt * 8;
  const int32_t* cb_row = sc.use_window ? cbox + (size_t)b * nt * 8 : nullptr;
  for (int t0 = 0; t0 < nt; t0 += kThreads) {
    // one round of candidate tiles: each thread tests one against the block box
    const int t = t0 + threadIdx.x;
    bool near = false;
    if (t < nt) {
      near = within_reach(tb_row + (size_t)t * 8, bqlo, bqhi, bq2, r2);
      if (near && cb_row != nullptr) near = within_window(cb_row + (size_t)t * 8, bclo, bchi, qrmax);
    }
    const unsigned bal = __ballot_sync(kFull, near);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int base = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (near) vis[base + __popc(bal & ((1u << lane) - 1u))] = t;
    __syncthreads();

    for (int k = 0; k < total; ++k) {
      const int tile = vis[k];
      {  // stage the tile
        const size_t j = (size_t)b * plen + (size_t)tile * kTile + threadIdx.x;
        sp[threadIdx.x] = pts[j];
        soi[threadIdx.x] = oi[j];
        if (cb_row != nullptr) scrd[threadIdx.x] = crd[j];
        if (threadIdx.x < 8) {
          stb[threadIdx.x] = tb_row[(size_t)tile * 8 + threadIdx.x];
        } else if (threadIdx.x < 16 && cb_row != nullptr) {
          scb[threadIdx.x - 8] = cb_row[(size_t)tile * 8 + threadIdx.x - 8];
        }
      }
      __syncthreads();
      bool mine = active && within_reach(stb, q, q, q2, r2);
      if (mine && cb_row != nullptr) mine = within_window(scb, qc, qc, qrmax);
      if (mine) {  // warp-uniform
        ++visited;
        for (int s0 = 0; s0 < kTile; s0 += 32) {
          const int sj = s0 + lane;
          const float4 p = sp[sj];
          const int oj = soi[sj];
          const bool in = oj >= 0;
          float d2 = 0.f;
          int dc0 = 0, dc1 = 0, dc2 = 0;
          if (in) {
            const float cross = __fadd_rn(__fadd_rn(__fmul_rn(q.x, p.x), __fmul_rn(q.y, p.y)),
                                          __fmul_rn(q.z, p.z));
            d2 = __fsub_rn(__fadd_rn(q2, p.w), __fmul_rn(2.f, cross));
            d2 = d2 > 0.f ? d2 : 0.f;
            if (cb_row != nullptr) {
              const int4 c = scrd[sj];
              dc0 = abs(qc.x - c.x);
              dc1 = abs(qc.y - c.y);
              dc2 = abs(qc.z - c.z);
            }
          }
#pragma unroll
          for (int s = 0; s < kMaxScales; ++s) {
            if (s >= sc.n_scales) continue;
            const bool hit = in && d2 < sc.max_r2[s] && (!sc.has_min[s] || d2 >= sc.min_r2[s]) &&
                             (!sc.use_window || (dc0 <= sc.qr[s][0] && dc1 <= sc.qr[s][1] &&
                                                 dc2 <= sc.qr[s][2]));
            hits[s] += __popc(__ballot_sync(kFull, hit));
            const int ns = sc.ns[s];
            unsigned cand =
                __ballot_sync(kFull, hit && (fill[s] < ns || before(d2, oj, wd[s], wi[s])));
            while (cand) {
              const int src = __ffs(cand) - 1;
              cand &= cand - 1;
              const float cd = __shfl_sync(kFull, d2, src);
              const int ci = __shfl_sync(kFull, oj, src);
              if (fill[s] >= ns && !before(cd, ci, wd[s], wi[s])) continue;
              // entries before (cd, ci) stay; the rest move up one rank
              int pos = 0;
#pragma unroll
              for (int h = 0; h < kSlots; ++h)
                pos += __popc(__ballot_sync(
                    kFull, 32 * h + lane < fill[s] && before(lkey[s][h], lidx[s][h], cd, ci)));
              // rank 32 h - 1 (lane 31 of entry h - 1) moves up into lane 0 of entry h
              float carry_key = 0.f;
              int carry_idx = 0;
#pragma unroll
              for (int h = 0; h < kSlots; ++h) {
                const float up_key = __shfl_up_sync(kFull, lkey[s][h], 1);
                const int up_idx = __shfl_up_sync(kFull, lidx[s][h], 1);
                const float top_key = __shfl_sync(kFull, lkey[s][h], 31);
                const int top_idx = __shfl_sync(kFull, lidx[s][h], 31);
                const int rank = 32 * h + lane;
                if (rank == pos) {
                  lkey[s][h] = cd;
                  lidx[s][h] = ci;
                } else if (rank > pos) {
                  lkey[s][h] = lane == 0 ? carry_key : up_key;
                  lidx[s][h] = lane == 0 ? carry_idx : up_idx;
                }
                carry_key = top_key;
                carry_idx = top_idx;
              }
              if (fill[s] < ns) ++fill[s];
              // the k-th entry: rank ns - 1
#pragma unroll
              for (int h = 0; h < kSlots; ++h) {
                const float k_key = __shfl_sync(kFull, lkey[s][h], (ns - 1) & 31);
                const int k_idx = __shfl_sync(kFull, lidx[s][h], (ns - 1) & 31);
                if ((ns - 1) >> 5 == h) {
                  wd[s] = k_key;
                  wi[s] = k_idx;
                }
              }
            }
          }
        }
      }
      __syncthreads();  // the tile is consumed
    }
  }

  // (query, tile) pairs this block tested
  if (lane == 0) wcnt[warp] = visited;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += wcnt[w];
    visits_out[(size_t)b * gridDim.x + blockIdx.x] = sum;
  }
  if (!active) return;

  const size_t qrow = (size_t)b * m + qi;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s >= sc.n_scales) continue;
    const int ns = sc.ns[s];
    const int first = fill[s] > 0 ? __shfl_sync(kFull, lidx[s][0], 0) : 0;
    int mine[kSlots];
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
      const int rank = 32 * h + lane;
      mine[h] = rank < fill[s] ? lidx[s][h] : first;
      if (rank < ns) idx_out[qrow * total_ns + sc.offset[s] + rank] = mine[h];
    }
    if (lane == 0) cnt_out[qrow * sc.n_scales + s] = hits[s];
    if (grouped_out != nullptr) {
#pragma unroll
      for (int h = 0; h < kSlots; ++h) {
        for (int l = 32 * h; l < ns && l < 32 * (h + 1); ++l) {
          const int r = __shfl_sync(kFull, mine[h], l & 31);
          const float* src = payload + ((size_t)b * n + r) * d;
          float* dst = grouped_out + (qrow * total_ns + sc.offset[s] + l) * d;
          for (int c = lane; c < d; c += 32) dst[c] = src[c];
        }
      }
    }
  }
}

}  // namespace

// Prepared sources (grouping.tile_sources): pts (b, nt * 256, 4) f32, oi
// (b, nt * 256) i32, crd (b, nt * 256, 4) i32 or null, tbox (b, nt, 8) f32,
// cbox (b, nt, 8) i32 or null; payload (b, n, d) f32 or null in the original
// row order; q_xyz (b, m, 3) f32, q_coords (b, m, 3) i32 or null, qperm
// (b, m) i32. Outputs: idx (b, m, total_ns) i32, cnt (b, m, n_scales) i32,
// grouped (b, m, total_ns, d) f32 or null, visits (b, ceil(m / 8)) i32.
extern "C" int query_group_launch(const void* pts, const void* oi, const void* crd,
                                  const void* tbox, const void* cbox, int nt,
                                  const void* payload, int b, int n, int d, const void* q_xyz,
                                  const void* q_coords, const void* qperm, int m,
                                  GroupScales sc, int total_ns, void* idx_out, void* cnt_out,
                                  void* grouped_out, void* visits_out, void* stream) {
  if (sc.n_scales < 1 || sc.n_scales > kMaxScales || n <= 0 || m <= 0 || b <= 0 || nt <= 0)
    return cudaErrorInvalidValue;
  int ns_max = 0;
  for (int s = 0; s < sc.n_scales; ++s) {
    if (sc.ns[s] < 1 || sc.ns[s] > 32 * kMaxSlots) return cudaErrorInvalidValue;
    ns_max = sc.ns[s] > ns_max ? sc.ns[s] : ns_max;
  }
  if (sc.use_window && (crd == nullptr || cbox == nullptr || q_coords == nullptr))
    return cudaErrorInvalidValue;
  dim3 grid((m + kWarps - 1) / kWarps, b);
  auto kernel = ns_max > 32 ? query_group_kernel<2> : query_group_kernel<1>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const int32_t*>(oi),
      static_cast<const int4*>(crd), static_cast<const float*>(tbox),
      static_cast<const int32_t*>(cbox), nt, static_cast<const float*>(payload), n, d,
      static_cast<const float*>(q_xyz), static_cast<const int32_t*>(q_coords),
      static_cast<const int32_t*>(qperm), m, sc, total_ns, static_cast<int32_t*>(idx_out),
      static_cast<int32_t*>(cnt_out), static_cast<float*>(grouped_out),
      static_cast<int32_t*>(visits_out));
  return cudaGetLastError();
}
