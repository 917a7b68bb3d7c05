// K3: rulebook probe (rank and membership of query keys in sorted keys).
//
// Replaces the Pallas TPU kernel `_kernel` of
// tsm_det_pointcloud_tpu/ops/searchsorted_pallas.py:55. Per batch row:
//   rank(q)  = #{ v : skeys[v] <= q }
//   idx(q)   = max(rank - 1, 0)
//   found(q) = rank > 0 && skeys[rank - 1] == q && q < sentinel
// skeys is ascending per row (valid prefix, then a tail of the sentinel).
// Exact for any query order: rulebook taps are near-sorted (a constant key
// offset keeps order), the s_sa1 point keys come in FPS order.
//
// Bound: bytes — each query is read once, idx (4 bytes) and found (1 byte,
// stored straight into a torch.bool tensor) written once. The GPU form of
// the Pallas kernel's anchor windows is a block-shared key window:
//   1. a block of kQueries queries (one a thread) reduces the min and max of
//      its queries below the sentinel; queries >= sentinel are left out, as
//      the Pallas kernel leaves them out, or one out-of-grid tap per block
//      would widen every window to the whole row;
//   2. three warps find, with a 32-way search of the row in global memory
//      (four dependent loads at 40000 keys instead of sixteen), the window
//      [lo, hi) = the keys in [qmin, qmax], and the rank of the sentinel;
//   3. a window of at most kWindow keys is staged into shared memory with
//      coalesced loads, and every thread binary-searches the shared copy:
//      rank = lo + #{window <= q}. All keys before lo are < qmin <= q, so
//      the window holds both the rank and the key at rank - 1. A wider
//      window (queries spread over a row longer than kWindow) is searched
//      in global memory within [lo, hi) by the same threads;
//   4. a query equal to the sentinel takes the sentinel's rank; any other
//      query >= sentinel (none on the model's paths) searches the whole row.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 512;            // queries (threads) per block
constexpr int kWarps = kQueries / 32;
constexpr int kWindow = 11264;           // keys staged in shared memory (44 KB, under the
                                         // 48 KB a block has without opting in)
constexpr unsigned kFull = 0xffffffffu;

// #{ i in [0, n) : s[i] <= key } (strict: s[i] < key) for ascending s, by the
// whole warp: each round probes 32 evenly spaced keys and keeps the one
// chunk where the predicate turns false. Warp-uniform result.
__device__ int warp_count_le(const int32_t* __restrict__ s, int n, int32_t key, bool strict,
                             int lane) {
  int lo = 0, hi = n;  // the count lies in [lo, hi]; s[< lo] pass, s[>= hi] fail
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * step - 1;  // the last key of chunk `lane`
    bool pass = false;
    if (p < hi) {
      const int32_t v = __ldg(s + p);
      pass = strict ? v < key : v <= key;
    }
    const int c = __popc(__ballot_sync(kFull, pass));  // a prefix of the chunks
    lo += c * step;
    hi = min(hi, lo + step);
  }
  bool pass = false;
  if (lo + lane < hi) {
    const int32_t v = __ldg(s + lo + lane);
    pass = strict ? v < key : v <= key;
  }
  return lo + __popc(__ballot_sync(kFull, pass));
}

// #{ i in [0, n) : s[i] <= key }, one thread.
__device__ __forceinline__ int count_le(const int32_t* s, int n, int32_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kQueries)
probe_kernel(const int32_t* __restrict__ skeys, const int32_t* __restrict__ queries, int v,
             int q, int sentinel, int window_cap, int32_t* __restrict__ idx,
             bool* __restrict__ found) {
  extern __shared__ int32_t win[];
  __shared__ int32_t wmin[kWarps], wmax[kWarps];
  __shared__ int wbig[kWarps];
  __shared__ int bounds[3];  // lo, hi, rank of the sentinel

  const int b = blockIdx.y;
  const int i = blockIdx.x * kQueries + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t* s = skeys + (size_t)b * v;
  const size_t o = (size_t)b * q + i;
  const bool live = i < q;
  const int32_t key = live ? queries[o] : sentinel;
  const bool inside = live && key < sentinel;

  // 1. the block's min / max over its queries below the sentinel
  int32_t mn = __reduce_min_sync(kFull, inside ? key : INT_MAX);
  int32_t mx = __reduce_max_sync(kFull, inside ? key : INT_MIN);
  const int big = __any_sync(kFull, live && key >= sentinel);
  if (lane == 0) {
    wmin[warp] = mn;
    wmax[warp] = mx;
    wbig[warp] = big;
  }
  __syncthreads();
  if (warp < 3) {
    mn = lane < kWarps ? wmin[lane] : INT_MAX;
    mx = lane < kWarps ? wmax[lane] : INT_MIN;
    mn = __reduce_min_sync(kFull, mn);
    mx = __reduce_max_sync(kFull, mx);
    // 2. the window [lo, hi) holds the keys in [mn, mx]; empty without such queries
    int r = 0;
    if (warp == 0) {
      r = mn <= mx ? warp_count_le(s, v, mn, true, lane) : 0;
    } else if (warp == 1) {
      r = mn <= mx ? warp_count_le(s, v, mx, false, lane) : 0;
    } else if (__any_sync(kFull, lane < kWarps && wbig[lane])) {
      r = warp_count_le(s, v, sentinel, false, lane);
    }
    if (lane == 0) bounds[warp] = r;
  }
  __syncthreads();
  const int lo = bounds[0];
  const int w = bounds[1] - lo;
  const bool staged = w <= window_cap;

  // 3. stage the window
  if (staged) {
    for (int t = threadIdx.x; t < w; t += kQueries) win[t] = __ldg(s + lo + t);
    __syncthreads();
  }
  if (!live) return;

  int rank;
  bool hit = false;
  if (inside) {
    const int c = staged ? count_le(win, w, key) : count_le(s + lo, w, key);
    rank = lo + c;
    hit = c > 0 && (staged ? win[c - 1] : s[lo + c - 1]) == key;
  } else if (key == sentinel) {  // 4.
    rank = bounds[2];
  } else {
    rank = count_le(s, v, key);
  }
  idx[o] = rank > 0 ? rank - 1 : 0;
  found[o] = hit;
}

}  // namespace

// skeys (b, v) i32 ascending, queries (b, q) i32; idx (b, q) i32, found
// (b, q) bool (one byte, 0 or 1).
extern "C" int probe_launch(const void* skeys, const void* queries, int b, int v, int q,
                            int sentinel, void* idx, void* found, void* stream) {
  if (b <= 0 || v <= 0 || q <= 0) return cudaErrorInvalidValue;
  const int cap = v < kWindow ? v : kWindow;
  dim3 grid((q + kQueries - 1) / kQueries, b);
  probe_kernel<<<grid, kQueries, cap * sizeof(int32_t), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(skeys), static_cast<const int32_t*>(queries), v, q,
      sentinel, cap, static_cast<int32_t*>(idx), static_cast<bool*>(found));
  return cudaGetLastError();
}
