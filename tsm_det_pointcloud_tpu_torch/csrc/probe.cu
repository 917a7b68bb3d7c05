// K3: rulebook probe (rank and membership of query keys in sorted keys).
//
// Replaces the Pallas TPU kernel `_kernel` of
// tsm_det_pointcloud_tpu/ops/searchsorted_pallas.py:55. Per batch row:
//   rank(q)  = #{ v : skeys[v] <= q }
//   idx(q)   = max(rank - 1, 0)
//   found(q) = rank > 0 && skeys[rank - 1] == q && q < sentinel
// skeys is ascending per row (valid prefix, then a tail of the sentinel).
//
// Bound: bytes — each query is read once and two outputs are written; the
// key row (16 KB at V = 4096) stays in L1/L2 across the 12 binary-search
// steps. One thread per query. The TPU kernel avoided indexed loads with
// blocked compares over anchor windows; a GPU gathers cheaply, so a plain
// binary search is the direct form here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ skeys, const int32_t* __restrict__ queries, int v,
             int q, int sentinel, int32_t* __restrict__ idx, uint8_t* __restrict__ found) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= q) return;
  const int32_t* s = skeys + (size_t)b * v;
  const int32_t key = queries[(size_t)b * q + i];
  int lo = 0, hi = v;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(s + mid) <= key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const size_t o = (size_t)b * q + i;
  idx[o] = lo > 0 ? lo - 1 : 0;
  found[o] = (lo > 0 && __ldg(s + lo - 1) == key && key < sentinel) ? 1 : 0;
}

}  // namespace

// skeys (b, v) i32 ascending, queries (b, q) i32; idx (b, q) i32, found
// (b, q) u8.
extern "C" int probe_launch(const void* skeys, const void* queries, int b, int v, int q,
                            int sentinel, void* idx, void* found, void* stream) {
  if (b <= 0 || v <= 0 || q <= 0) return cudaErrorInvalidValue;
  dim3 grid((q + kThreads - 1) / kThreads, b);
  probe_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(skeys), static_cast<const int32_t*>(queries), v, q,
      sentinel, static_cast<int32_t*>(idx), static_cast<uint8_t*>(found));
  return cudaGetLastError();
}
