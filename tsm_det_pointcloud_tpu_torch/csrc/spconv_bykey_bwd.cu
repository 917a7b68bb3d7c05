// K5: backward of the by-key sparse-conv gather-GEMM (K4).
//
// Replaces the Pallas TPU kernel `_bykey_bwd_kernel` of
// tsm_det_pointcloud_tpu/ops/spconv_pallas.py:383 (entry
// `gather_matmul_bykey_bwd`, :477). With row(b, k, q) the slot of skeys[b]
// that equals qkeys[b, k, q] (none when not found or >= sentinel):
//   dW[k]          = sum_{b, q found}  f[b, row]^T . g[b, q]        (C x Co)
//   df[b, row, :]  = sum_k  g[b, q(b, k, row)] . W[k]^T            (C)
//
// Domain: maps that are injective per tap (within one tap distinct targets
// name distinct rows), which every rulebook the port builds is: a subm conv's
// target keys are its own voxels shifted by one offset, a strided conv's are
// its distinct outputs scaled and shifted, an inverse conv's its distinct
// fine voxels shifted and divided exactly. A map that names a row twice in
// one tap fails the launch (__trap), never a silent overwrite.
//
// Bounds: the two products (4 C Co operations a hit) against the bytes of f,
// g, df, W and dW once each: float32 outside the tensor cores (67 TFLOP/s),
// or the 3xTF32 rate this kernel runs at (495 / 3 = 165 TFLOP/s).
//
// Design: four launches on the stream, no float atomics, bit-equal on repeat.
//   1. `invert_kernel` probes every (b, k, q) once (a binary search) and
//      claims inv[b, k, row] = q in a table set to -1 beforehand; the claim is
//      an integer compare-and-swap, and a slot already claimed (a map that is
//      not injective) traps.
//   2. dW (`dw_kernel`): a block owns one tap, one tile of (C, Co) (up to
//      128 x 128) and one of `slots` slots (16 blocks an SM over the taps and
//      tiles, from the device's SM count, at most 32 MiB of partial tiles),
//      and walks its share of the source rows in passes of 256, in a fixed
//      order. A pass reads the 256 rows' table entries (one a thread) and
//      compacts the hits (a ballot a warp, a prefix over the warps) into one
//      of two lists. The hits stream through two stages of 32 by cp.async,
//      the f rows and the g rows of a stage gathered while the one before is
//      multiplied (the next pass is compacted when this one runs out); the
//      product f^T g over the hits runs as 3xTF32 mma.sync m16n8k8, each
//      fragment split into TF32 hi and lo as it is loaded (float32-level
//      error). Rows past a stage's hits are zero-filled: here the hits are
//      the product's depth, not its rows. Each block writes its partial tile
//      to its slot; with more than one slot, 3. `sum_slots_kernel` adds the
//      slots in slot order into dW. Measured on the Waymo training step's
//      calls (H100): more slots even out taps and passes whose hits differ
//      (a subm conv's centre tap hits every row), and splitting the staged
//      rows once, as K4 does, was no faster here.
//   4. df is K4's gather-GEMM (csrc/bykey_gemm.cuh) with the roles swapped:
//      g is the gathered matrix, W^T (K, Co, C) the weights and the inverse
//      table the row source (`bykey::TableRows`), so every source row sums
//      its taps in tap order in an f32 shared tile and is written once (zero
//      where no tap names it).
#include "bykey_gemm.cuh"

namespace {

using bykey::kFull;
using bykey::kThreads;
using bykey::kWarps;

constexpr int kPass = kThreads;  // source rows a compaction pass (one a thread)
constexpr int kHit = 32;         // hit rows a stage of the dW product
constexpr int kSlotWaves = 16;   // dW blocks an SM to aim for
constexpr size_t kPartFloats = (size_t)32 << 18;  // the slots' partial tiles: 32 MiB at most

// the claim of every found target: inv[b, k, row] = q
__global__ void invert_kernel(const int32_t* __restrict__ skeys, const int32_t* __restrict__ qkeys,
                              int b_sz, int v, int k_taps, int q, int sentinel,
                              int32_t* __restrict__ inv) {
  const size_t n = (size_t)b_sz * k_taps * q;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int32_t key = __ldg(qkeys + i);
    if (key >= sentinel) continue;
    const size_t bk = i / q;  // b * k_taps + k
    const int32_t* sk = skeys + (bk / k_taps) * v;
    int lo = 0, hi = v;  // lower bound
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(sk + mid) < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < v && __ldg(sk + lo) == key &&
        atomicCAS(inv + bk * v + lo, -1, static_cast<int32_t>(i % q)) != -1)
      __trap();  // two targets of one tap name one row: not a map K5 takes
  }
}

// a warp: MT 16-row tiles of C and NT 8-column tiles of Co; the warps 4 x 2
template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
dw_kernel(const float* __restrict__ f, const float* __restrict__ g,
          const int32_t* __restrict__ inv, int b_sz, int v, int c, int k_taps, int q, int co,
          int vec, float* __restrict__ part) {
  constexpr int TM = 4 * 16 * MT;  // C rows of the block's tile
  constexpr int TN = 2 * 8 * NT;   // Co columns
  constexpr int SA = TM + 8;       // = 8 mod 32: conflict-free fragments
  constexpr int SB = TN + 8;
  constexpr int SSTAGE = kHit * (SA + SB);
  extern __shared__ __align__(16) float smem_f[];  // two stages: f rows, then g rows
  __shared__ int s_hv[2][kPass], s_hq[2][kPass];   // two passes' hits: source row, target
  __shared__ int s_wn[kWarps];

  const int k = blockIdx.y;
  const int n_tiles_n = (co + TN - 1) / TN;
  const int c0 = (blockIdx.z / n_tiles_n) * TM;
  const int n0 = (blockIdx.z % n_tiles_n) * TN;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int gq = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;   // fragment thread-in-group
  const int wm = (warp >> 1) * 16 * MT;
  const int wn = (warp & 1) * 8 * NT;
  const int n_pass = (v + kPass - 1) / kPass;
  const int passes = b_sz * n_pass;

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0.f;

  // the hits of pass ps into list L, in source-row order; returns their
  // count (the same in every thread)
  auto compact = [&](int ps, int L) {
    const int vv = (ps % n_pass) * kPass + t;
    const int qv = vv < v ? __ldg(inv + ((size_t)(ps / n_pass) * k_taps + k) * v + vv) : -1;
    const unsigned m = __ballot_sync(kFull, qv >= 0);
    if (lane == 0) s_wn[warp] = __popc(m);
    __syncthreads();
    int base = 0, n = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      base += i < warp ? s_wn[i] : 0;
      n += s_wn[i];
    }
    if (qv >= 0) {
      const int p = base + __popc(m & ((1u << lane) - 1u));
      s_hv[L][p] = vv;
      s_hq[L][p] = qv;
    }
    __syncthreads();  // the list is complete, and s_wn free again
    return n;
  };
  // the first pass at or after ps with a hit, compacted into list L;
  // returns its count, 0 (and ps past the end) when none is left
  auto next_pass = [&](int& ps, int L) {
    for (; ps < passes; ps += gridDim.x) {
      const int n = compact(ps, L);
      if (n) return n;
    }
    return 0;
  };
  // rows of src (f or g) for hits h0 .. h0 + rows - 1 of list hr, columns
  // x0 .. x0 + T - 1 of width `width`, into a stage of stride S by cp.async;
  // rows up to a multiple of 8 and columns past the width are zero-filled
  auto issue = [&](const float* src, const int* hr, int rows, int x0, int width, int T, int S,
                   float* dst) {
    const int rows8 = bykey::round8(rows);
    if (vec) {
      const int nv = T / 4;
      for (int e = t; e < rows8 * nv; e += kThreads) {
        const int j = e / nv, xv = (e % nv) * 4;
        const bool ok = j < rows && x0 + xv < width;
        bykey::cp_async16(dst + j * S + xv, ok ? src + (size_t)hr[j] * width + x0 + xv : src,
                          ok ? 16 : 0);
      }
    } else {
      for (int e = t; e < rows8 * T; e += kThreads) {
        const int j = e / T, x = e % T;
        const bool ok = j < rows && x0 + x < width;
        bykey::cp_async4(dst + j * S + x, ok ? src + (size_t)hr[j] * width + x0 + x : src,
                         ok ? 4 : 0);
      }
    }
  };
  auto issue_chunk = [&](int ps, int L, int h0, int rows, int st) {
    const int b = ps / n_pass;
    float* sa = smem_f + st * SSTAGE;
    issue(f + (size_t)b * v * c, s_hv[L] + h0, rows, c0, c, TM, SA, sa);
    issue(g + (size_t)b * q * co, s_hq[L] + h0, rows, n0, co, TN, SB, sa + kHit * SA);
  };

  // a stream of chunks of kHit hits over this slot's passes, two in flight:
  // the next chunk's rows are copied while this one is multiplied
  int ps = blockIdx.x, L = 0, h0 = 0, st = 0;
  int n = next_pass(ps, L);
  if (n) issue_chunk(ps, L, 0, min(kHit, n), 0);
  bykey::cp_async_commit();
  while (h0 < n) {
    const int rows8 = bykey::round8(min(kHit, n - h0));
    // the next chunk: later in this pass, or the first of the next pass with a hit
    int nps = ps, nL = L, nh0 = h0 + kHit, nn = n;
    if (nh0 >= n) {
      nps += gridDim.x;
      nL = 1 - L;
      nh0 = 0;
      nn = next_pass(nps, nL);
    }
    if (nh0 < nn) issue_chunk(nps, nL, nh0, min(kHit, nn - nh0), st ^ 1);
    bykey::cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this chunk's copies
    __syncthreads();
    const float* sa = smem_f + st * SSTAGE;
    const float* sb = sa + kHit * SA;
    for (int ks = 0; ks < rows8 / 8; ++ks) {
      const int r0 = ks * 8 + tq;
      const int r1 = r0 + 4;
      // A = f^T: a0 (C row gq, hit tq), a1 (gq + 8, tq), a2 (gq, tq + 4), a3 (gq + 8, tq + 4)
      uint32_t fh[MT][4], fl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int col = wm + mt * 16 + gq;
        bykey::split(sa[r0 * SA + col], fh[mt][0], fl[mt][0]);
        bykey::split(sa[r0 * SA + col + 8], fh[mt][1], fl[mt][1]);
        bykey::split(sa[r1 * SA + col], fh[mt][2], fl[mt][2]);
        bykey::split(sa[r1 * SA + col + 8], fh[mt][3], fl[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // B = g: b0 (hit tq, Co column gq), b1 (tq + 4, gq)
        const int col = wn + nt * 8 + gq;
        uint32_t gh[2], gl[2];
        bykey::split(sb[r0 * SB + col], gh[0], gl[0]);
        bykey::split(sb[r1 * SB + col], gh[1], gl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) bykey::mma3(acc[mt][nt], fh[mt], fl[mt], gh, gl);
      }
    }
    __syncthreads();  // this stage is refilled by the chunk after next
    ps = nps, L = nL, h0 = nh0, n = nn, st ^= 1;
  }

  // ---- this block's partial tile into its slot ----
  float* out = part + ((size_t)blockIdx.x * k_taps + k) * c * co;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int row = c0 + wm + mt * 16 + gq;
      const int col = n0 + wn + nt * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= c) continue;
        if (col < co) out[(size_t)r * co + col] = acc[mt][nt][2 * h];
        if (col + 1 < co) out[(size_t)r * co + col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

// dW = the slots' partial tiles added in slot order
__global__ void sum_slots_kernel(const float* __restrict__ part, int slots, size_t n,
                                 float* __restrict__ dw) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int sl = 1; sl < slots; ++sl) s += part[sl * n + i];
    dw[i] = s;
  }
}

int tile_m(int c) { return c <= 64 ? 64 : 128; }
int tile_n(int co) { return co <= 64 ? 64 : 128; }

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms[dev];
}

int plan_slots(int b, int v, int c, int k_taps, int co) {
  const int tiles = ((c + tile_m(c) - 1) / tile_m(c)) * ((co + tile_n(co) - 1) / tile_n(co));
  const int passes = b * ((v + kPass - 1) / kPass);
  const int per = k_taps * tiles;
  int slots = (kSlotWaves * sm_count() + per - 1) / per;
  const int cap = (int)(kPartFloats / ((size_t)k_taps * c * co));
  slots = slots > cap ? cap : slots;
  return slots < 1 ? 1 : (slots > passes ? passes : slots);
}

template <int MT, int NT>
cudaError_t launch_dw(const float* f, const float* g, const int32_t* inv, int b, int v, int c,
                      int k_taps, int q, int co, int slots, float* part, cudaStream_t st) {
  constexpr int TM = 64 * MT, TN = 16 * NT;
  const int smem = (int)sizeof(float) * 2 * kHit * (TM + 8 + TN + 8);
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(dw_kernel<MT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  const int vec = c % 4 == 0 && co % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(g) % 16 == 0;
  dim3 grid(slots, k_taps, ((c + TM - 1) / TM) * ((co + TN - 1) / TN));
  dw_kernel<MT, NT><<<grid, kThreads, smem, st>>>(f, g, inv, b, v, c, k_taps, q, co, vec, part);
  return cudaGetLastError();
}

}  // namespace

// The number of dW slots (partial tiles of each (tap, tile)) for these
// shapes on the current device: out1 (1,) i32. The caller allocates the
// slots' partial sums, (slots, k, c, co) f32, when there is more than one.
extern "C" int bykey_bwd_plan(int b, int v, int c, int k_taps, int co, void* out1) {
  if (b <= 0 || v <= 0 || c <= 0 || k_taps <= 0 || co <= 0) return cudaErrorInvalidValue;
  *static_cast<int*>(out1) = plan_slots(b, v, c, k_taps, co);
  return cudaSuccess;
}

// f (b, v, c) f32, skeys (b, v) i32 ascending, qkeys (b, k, q) i32 injective
// per tap, wt (k, co, c) f32 (the weight's transpose), g (b, q, co) f32;
// scratch inv (b, k, v) i32 and, when slots > 1, part (slots, k, c, co)
// f32; out df (b, v, c) and dw (k, c, co) f32, every element written.
extern "C" int bykey_bwd_launch(const void* f, const void* skeys, const void* qkeys,
                                const void* wt, const void* g, int b, int v, int c, int k_taps,
                                int q, int co, int sentinel, int slots, void* inv, void* part,
                                void* df, void* dw, void* stream) {
  if (b <= 0 || v <= 0 || c <= 0 || k_taps <= 0 || k_taps > bykey::kMaxTaps || q <= 0 ||
      co <= 0 || slots != plan_slots(b, v, c, k_taps, co) || (slots > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* fp = static_cast<const float*>(f);
  const auto* gp = static_cast<const float*>(g);
  auto* tab = static_cast<int32_t*>(inv);
  // 1. the inverse table
  cudaError_t err = cudaMemsetAsync(tab, 0xff, sizeof(int32_t) * (size_t)b * k_taps * v, st);
  if (err != cudaSuccess) return err;
  const size_t n_keys = (size_t)b * k_taps * q;
  const int inv_blocks = (int)((n_keys + kThreads - 1) / kThreads < 4096
                                   ? (n_keys + kThreads - 1) / kThreads
                                   : 4096);
  invert_kernel<<<inv_blocks, kThreads, 0, st>>>(static_cast<const int32_t*>(skeys),
                                                 static_cast<const int32_t*>(qkeys), b, v,
                                                 k_taps, q, sentinel, tab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 2. dW into the slots (or straight into dw), 3. the slots added
  float* dst = slots > 1 ? static_cast<float*>(part) : static_cast<float*>(dw);
  if (c <= 64) {
    err = co <= 64 ? launch_dw<1, 4>(fp, gp, tab, b, v, c, k_taps, q, co, slots, dst, st)
                   : launch_dw<1, 8>(fp, gp, tab, b, v, c, k_taps, q, co, slots, dst, st);
  } else {
    err = co <= 64 ? launch_dw<2, 4>(fp, gp, tab, b, v, c, k_taps, q, co, slots, dst, st)
                   : launch_dw<2, 8>(fp, gp, tab, b, v, c, k_taps, q, co, slots, dst, st);
  }
  if (err != cudaSuccess) return err;
  if (slots > 1) {
    const size_t n = (size_t)k_taps * c * co;
    const int blocks = (int)((n + kThreads - 1) / kThreads < 1024 ? (n + kThreads - 1) / kThreads
                                                                 : 1024);
    sum_slots_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const float*>(part), slots, n,
                                                  static_cast<float*>(dw));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // 4. df: K4's gather-GEMM of g by W^T, rows from the inverse table
  return bykey::gemm_launch(gp, bykey::TableRows{tab}, static_cast<const float*>(wt), b, q, co,
                            k_taps, v, c, static_cast<float*>(df), st);
}
