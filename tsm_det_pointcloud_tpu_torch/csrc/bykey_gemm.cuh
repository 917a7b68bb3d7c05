// The by-key gather-GEMM on tensor cores, shared by K4 (csrc/spconv_bykey.cu)
// and K5's df route (csrc/spconv_bykey_bwd.cu):
//   out[b, q, :] = sum_k  W[k]^T . f[b, row(b, k, q), :]     (rows unique per tap)
// where row(b, k, q) comes from a row source: K4 probes the sorted keys
// (`ProbeRows`), K5's df reads a per-tap inverse table (`TableRows`).
//
// Design (measured on K4 in its file's header). A block owns 64 output rows
// and all output columns (up to 256; a grid column per further 256). The row
// source fills every (tap, row) slot once; each warp then compacts its taps'
// hit rows (a ballot and a prefix count), so that only hits are gathered.
// The work is a list of (active tap, 32-channel chunk) items in tap order, on
// a two-stage ring with one barrier an item: item i + 1's weight slice comes
// by cp.async and its gathered rows are loaded into registers while item i is
// multiplied. The product runs on the tensor cores in split precision
// (3xTF32): each operand x is hi = tf32(x) plus lo = tf32(x - hi), and
// hi.hi + hi.lo + lo.hi accumulates in f32 with mma.sync m16n8k8, which keeps
// float32-level error. The gathered rows are split once, as they are stored,
// into hi and lo planes that every warp reads with ldmatrix; a warp splits
// only its own columns of the weight slice. A warp owns a fixed slice of the
// columns and all (up to four) 16-row tiles of compacted hits; at a tap's
// last chunk it adds its fragments to their own rows of an f32 output tile in
// shared memory. Rows are unique within a tap and the slice is the warp's
// alone, so the sums need no atomics and run in tap order: two launches give
// bit-equal output. Rows q >= Q are never written; every other row is, zeros
// where no tap hits.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace bykey {
namespace {  // internal linkage: each kernel library keeps its own statics

constexpr int kRows = 64;            // output rows per block
constexpr int kMTiles = kRows / 16;  // 16-row tiles of compacted hits
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;            // reduction channels per ring stage
constexpr int kAStride = kChunk + 4;  // floats a staged row: conflict-free A fragments
constexpr int kMaxCols = 256;         // output columns per block
constexpr int kMaxTaps = 64;
constexpr int kProbeIlp = 8;          // binary searches in flight a thread
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
// row stride of the staged weight slice: >= the columns, = 8 mod 32, so that
// a warp's B fragments (8 columns x 4 rows) fall in 32 distinct banks
__host__ __device__ inline int w_stride(int np) { return np + ((8 - np % 32) + 32) % 32; }
// a stage: the rows' hi and lo planes, then the weight slice
__host__ __device__ inline int stage_floats(int np) {
  return 2 * kRows * kAStride + kChunk * w_stride(np);
}
__host__ __device__ inline int out_floats(int np, int k_taps) {
  const int tile = kRows * (np + 4);  // the output tile; the row slots before it
  return tile > k_taps * kRows ? tile : k_taps * kRows;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- or 4-byte async copies into shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// four 8x8 b16 matrices: each lane gets its row of each, here a TF32 fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~22 bits, both in TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the three split products of one fragment pair, in one fixed order
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// K4's row source: the slot of skeys[b] that equals qkeys[b, k, q] (-1 when
// not found or >= sentinel), every (tap, row) probed once: a branchless
// binary search, eight in flight a thread.
struct ProbeRows {
  const int32_t* skeys;  // (b, v) ascending
  const int32_t* qkeys;  // (b, k, q)
  int v;
  int sentinel;

  __device__ void fill(int* s_slot, int b, int q0, int q, int k_taps) const {
    const int t = threadIdx.x;
    const int32_t* sk = skeys + (size_t)b * v;
    const int items = k_taps * kRows;
    for (int base = 0; base < items; base += kThreads * kProbeIlp) {
      int key[kProbeIlp], pos[kProbeIlp];
#pragma unroll
      for (int j = 0; j < kProbeIlp; ++j) {
        const int it = base + j * kThreads + t;
        key[j] = sentinel;
        if (it < items && q0 + it % kRows < q)
          key[j] = qkeys[((size_t)b * k_taps + it / kRows) * q + q0 + it % kRows];
        pos[j] = 0;
      }
      for (int n = v; n > 1;) {  // the same trip count for every key
        const int half = n >> 1;
#pragma unroll
        for (int j = 0; j < kProbeIlp; ++j)
          pos[j] = __ldg(sk + pos[j] + half) < key[j] ? pos[j] + half : pos[j];
        n -= half;
      }
#pragma unroll
      for (int j = 0; j < kProbeIlp; ++j) {
        const int it = base + j * kThreads + t;
        if (it < items) {
          const int p = pos[j] + (__ldg(sk + pos[j]) < key[j] ? 1 : 0);
          s_slot[it] = (key[j] < sentinel && p < v && __ldg(sk + p) == key[j]) ? p : -1;
        }
      }
    }
  }
};

// K5's df row source: a table (b, k, q) of the gathered row of output row q
// at tap k, or -1.
struct TableRows {
  const int32_t* table;

  __device__ void fill(int* s_slot, int b, int q0, int q, int k_taps) const {
    for (int it = threadIdx.x; it < k_taps * kRows; it += kThreads) {
      const int r = it % kRows;
      s_slot[it] = q0 + r < q ? __ldg(table + ((size_t)b * k_taps + it / kRows) * q + q0 + r) : -1;
    }
  }
};

// NT: 8-column tiles a warp owns (its slice is NT * 8 columns)
template <int NT, class Rows>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ f, Rows rows, const float* __restrict__ w, int v, int c,
            int k_taps, int q, int co, int vec_f, int vec_w, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_cnt[kMaxTaps];  // hits of each tap
  __shared__ int s_act[kMaxTaps];  // the taps with a hit, in order
  __shared__ int s_nact;

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int n_base = blockIdx.y * kMaxCols;
  const int ncols = min(kMaxCols, co - n_base);
  const int np = round8(ncols);
  const int ostride = np + 4;
  const int wstride = w_stride(np);
  const int sfl = stage_floats(np);
  const int n_chunks = (c + kChunk - 1) / kChunk;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;  // fragment thread-in-group

  float* s_stage = smem;                               // the ring's two stages
  float* s_out = smem + 2 * sfl;                       // kRows x ostride output tile
  int* s_slot = reinterpret_cast<int*>(s_out);         // (taps, kRows) row slots, first
  int* s_hslot = reinterpret_cast<int*>(s_out + out_floats(np, k_taps));  // compacted slots
  uint8_t* s_hrow = reinterpret_cast<uint8_t*>(s_hslot + k_taps * kRows);  // and their rows

  const float* fb = f + (size_t)b * v * c;

  // ---- 1. every (tap, row) slot once ----
  rows.fill(s_slot, b, q0, q, k_taps);
  __syncthreads();

  // ---- 2. compact each tap's hits: a ballot and a prefix count a 32 rows ----
  for (int kk = warp; kk < k_taps; kk += kWarps) {
    int n = 0;
#pragma unroll
    for (int h = 0; h < kRows / 32; ++h) {
      const int sl = s_slot[kk * kRows + 32 * h + lane];
      const unsigned m = __ballot_sync(kFull, sl >= 0);
      if (sl >= 0) {
        const int p = n + __popc(m & ((1u << lane) - 1u));
        s_hslot[kk * kRows + p] = sl;
        s_hrow[kk * kRows + p] = static_cast<uint8_t>(32 * h + lane);
      }
      n += __popc(m);
    }
    if (lane == 0) s_cnt[kk] = n;
  }
  __syncthreads();
  if (warp == 0) {
    int n_act = 0;
    for (int k0 = 0; k0 < k_taps; k0 += 32) {
      const int kk = k0 + lane;
      const bool act = kk < k_taps && s_cnt[kk] > 0;
      const unsigned m = __ballot_sync(kFull, act);
      if (act) s_act[n_act + __popc(m & ((1u << lane) - 1u))] = kk;
      n_act += __popc(m);
    }
    if (lane == 0) s_nact = n_act;
  }
  for (int e = t; e < kRows * ostride; e += kThreads) s_out[e] = 0.f;  // the slots are spent
  __syncthreads();
  const int n_items = s_nact * n_chunks;

  // ---- 3. the ring: stage item i + 1 while item i is multiplied ----
  // The weight slice comes by cp.async. The gathered rows come through
  // registers: loaded before item i's product, split into TF32 hi and lo
  // and stored after it, once for all warps (each warp reads every row).
  float ga[kRows * kChunk / kThreads];
  auto load_rows = [&](int item) {
    const int kk = s_act[item / n_chunks];
    const int c0 = (item % n_chunks) * kChunk;
    const int cnt = s_cnt[kk];
    const int* hs = s_hslot + kk * kRows;
    if (vec_f) {
#pragma unroll
      for (int i = 0; i < kRows * kChunk / 4 / kThreads; ++i) {
        const int e = t + i * kThreads, j = e >> 3, cv = (e & 7) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < cnt && c0 + cv < c)
          x = __ldg(reinterpret_cast<const float4*>(fb + (size_t)hs[j] * c + c0 + cv));
        ga[4 * i] = x.x, ga[4 * i + 1] = x.y, ga[4 * i + 2] = x.z, ga[4 * i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRows * kChunk / kThreads; ++i) {
        const int e = t + i * kThreads, j = e >> 5, cc = e & 31;
        ga[i] = (j < cnt && c0 + cc < c) ? __ldg(fb + (size_t)hs[j] * c + c0 + cc) : 0.f;
      }
    }
  };
  auto store_rows = [&](int item, int buf) {
    const int cnt = s_cnt[s_act[item / n_chunks]];
    uint32_t* ah = reinterpret_cast<uint32_t*>(s_stage + buf * sfl);
    uint32_t* al = ah + kRows * kAStride;
    if (vec_f) {
#pragma unroll
      for (int i = 0; i < kRows * kChunk / 4 / kThreads; ++i) {
        const int e = t + i * kThreads, j = e >> 3, cv = (e & 7) * 4;
        if (j < cnt) {
          uint4 h, l;
          split(ga[4 * i], h.x, l.x);
          split(ga[4 * i + 1], h.y, l.y);
          split(ga[4 * i + 2], h.z, l.z);
          split(ga[4 * i + 3], h.w, l.w);
          *reinterpret_cast<uint4*>(ah + j * kAStride + cv) = h;
          *reinterpret_cast<uint4*>(al + j * kAStride + cv) = l;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRows * kChunk / kThreads; ++i) {
        const int e = t + i * kThreads, j = e >> 5, cc = e & 31;
        if (j < cnt) split(ga[i], ah[j * kAStride + cc], al[j * kAStride + cc]);
      }
    }
  };
  auto stage_w = [&](int item, int buf) {
    const int kk = s_act[item / n_chunks];
    const int c0 = (item % n_chunks) * kChunk;
    float* sw = s_stage + buf * sfl + 2 * kRows * kAStride;
    const float* wk = w + (size_t)kk * c * co + n_base;
    if (vec_w) {
      const int nv = np / 4;
      for (int e = t; e < kChunk * nv; e += kThreads) {
        const int r = e / nv, nn = (e % nv) * 4;
        const bool ok = c0 + r < c && nn < ncols;
        cp_async16(sw + r * wstride + nn, ok ? wk + (size_t)(c0 + r) * co + nn : w, ok ? 16 : 0);
      }
    } else {
      for (int e = t; e < kChunk * np; e += kThreads) {
        const int r = e / np, nn = e % np;
        const bool ok = c0 + r < c && nn < ncols;
        cp_async4(sw + r * wstride + nn, ok ? wk + (size_t)(c0 + r) * co + nn : w, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  const int wcol = warp * NT * 8;  // this warp's first column
  float acc[kMTiles][NT][4];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0.f;

  if (n_items > 0) {
    stage_w(0, 0);
    load_rows(0);
    store_rows(0, 0);
  }
  for (int it = 0; it < n_items; ++it) {
    cp_async_wait_all();  // item it's weight slice has landed (this thread's copies)
    // every thread's copies and rows are in, and every warp is done with
    // item it - 1, whose stage is refilled next
    __syncthreads();
    const bool next = it + 1 < n_items;
    if (next) {
      stage_w(it + 1, (it + 1) & 1);
      load_rows(it + 1);
    }
    const int kk = s_act[it / n_chunks];
    const int cnt = s_cnt[kk];
    const int mt = (cnt + 15) >> 4;
    const uint32_t* sah = reinterpret_cast<const uint32_t*>(s_stage + (it & 1) * sfl);
    const uint32_t* sal = sah + kRows * kAStride;
    const float* sw = s_stage + (it & 1) * sfl + 2 * kRows * kAStride;
    if (wcol < np) {
      // rows cnt .. 16 mt - 1 of the stage hold stale values: their output
      // rows are never added, and a row of the product depends on its own
      // row of A alone. ldmatrix: lanes 0-7, 8-15, 16-23, 24-31 address
      // the rows of a0 (rows 0-7, columns 0-3), a1 (8-15, 0-3), a2 (0-7,
      // 4-7) and a3 (8-15, 4-7); a row of 4 TF32 is one of 8 b16
      const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kAStride + (lane >> 4) * 4;
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* bp = sw + (ks * 8 + tq) * wstride + wcol + nt * 8 + g;
          split(bp[0], bh[nt][0], bl[nt][0]);
          split(bp[4 * wstride], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          if (m < mt) {
            uint32_t ah[4], al[4];
            ldmatrix_x4(ah, sah + m * 16 * kAStride + ks * 8 + a_off);
            ldmatrix_x4(al, sal + m * 16 * kAStride + ks * 8 + a_off);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma3(acc[m][nt], ah, al, bh[nt], bl[nt]);
          }
        }
      }
      if (it % n_chunks == n_chunks - 1) {  // the tap is done: add it to its rows
        const uint8_t* hr = s_hrow + kk * kRows;
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int j = m * 16 + g;
            const int col = wcol + nt * 8 + 2 * tq;
            if (j < cnt && col < np) {  // a warp's last tile may lie past the columns
              float2* o = reinterpret_cast<float2*>(s_out + hr[j] * ostride + col);
              float2 x = *o;
              x.x += acc[m][nt][0];
              x.y += acc[m][nt][1];
              *o = x;
            }
            if (j + 8 < cnt && col < np) {
              float2* o = reinterpret_cast<float2*>(s_out + hr[j + 8] * ostride + col);
              float2 x = *o;
              x.x += acc[m][nt][2];
              x.y += acc[m][nt][3];
              *o = x;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0.f;
          }
        }
      }
    }
    if (next) store_rows(it + 1, (it + 1) & 1);
  }
  __syncthreads();  // every warp's last tap is in the tile

  // ---- 4. the tile out: rows q < Q only ----
  for (int e = t; e < kRows * ncols; e += kThreads) {
    const int r = e / ncols, n = e % ncols;
    if (q0 + r < q) out[((size_t)b * q + q0 + r) * co + n_base + n] = s_out[r * ostride + n];
  }
}

template <int NT, class Rows>
cudaError_t launch_nt(const float* f, Rows rows, const float* w, int b, int v, int c, int k_taps,
                      int q, int co, float* out, cudaStream_t stream) {
  const int np = round8(co < kMaxCols ? co : kMaxCols);
  const size_t smem = sizeof(float) * (2 * (size_t)stage_floats(np) + out_floats(np, k_taps)) +
                      sizeof(int) * (size_t)k_taps * kRows + (size_t)k_taps * kRows;
  // the attribute is raised once per device and size, not at every launch
  static size_t smem_allowed[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || smem > smem_allowed[dev]) {
    err = cudaFuncSetAttribute(gemm_kernel<NT, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_allowed[dev] = smem;
  }
  const int vec_f = c % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  const int vec_w = co % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid((q + kRows - 1) / kRows, (co + kMaxCols - 1) / kMaxCols, b);
  gemm_kernel<NT, Rows><<<grid, kThreads, smem, stream>>>(f, rows, w, v, c, k_taps, q, co, vec_f,
                                                          vec_w, out);
  return cudaGetLastError();
}

// out (b, q, co) = the gather-GEMM of f (b, v, c) by w (k_taps, c, co), rows
// from `rows`. A warp owns NT 8-column tiles of the block's columns (up to 256).
template <class Rows>
cudaError_t gemm_launch(const float* f, Rows rows, const float* w, int b, int v, int c, int k_taps,
                        int q, int co, float* out, cudaStream_t stream) {
  if (b <= 0 || v <= 0 || c <= 0 || k_taps <= 0 || k_taps > kMaxTaps || q <= 0 || co <= 0)
    return cudaErrorInvalidValue;
  const int tiles = round8(co < kMaxCols ? co : kMaxCols) / 8;
  if (tiles <= kWarps) return launch_nt<1>(f, rows, w, b, v, c, k_taps, q, co, out, stream);
  if (tiles <= 2 * kWarps) return launch_nt<2>(f, rows, w, b, v, c, k_taps, q, co, out, stream);
  return launch_nt<4>(f, rows, w, b, v, c, k_taps, q, co, out, stream);
}

}  // namespace
}  // namespace bykey
