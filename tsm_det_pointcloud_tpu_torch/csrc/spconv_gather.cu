// K7: index-based sparse-conv gather-GEMM over a materialised rulebook.
//
// Replaces the Pallas TPU kernel `_kernel` of
// tsm_det_pointcloud_tpu/ops/spconv_pallas.py:45 (its pallas_call at :106,
// entry `gather_matmul` at :618):
//   out[b, q, :] = sum_k  W[k]^T . f[b, idx[b, k, q], :]
// where an index of -1 (or one >= V) contributes zero. f32 in, f32
// accumulation, f32 out.
//
// The TPU kernel builds a one-hot matrix over a window of source rows and
// multiplies it on the MXU, because Mosaic has no vector gather, and it
// drops to bf16 when the padded feature block passes its 12 MB VMEM budget.
// Neither carries over: here a block loads its rows by index and stays at
// float32-level error.
//
// Bounds, counting the hits only (2 C Co operations a hit): float32 outside
// the tensor cores (67 TFLOP/s) and the 3xTF32 rate this kernel runs at
// (495 / 3 = 165 TFLOP/s), against the bytes (the indices, each named row,
// W and out once each at 3.35 TB/s). SECOND's stem (C in {4, 16, 32, 64},
// Co in {16, 32, 64, 128}, K = 27 or 3, V = Q = 40000 a scan at eval, 16000
// in training) is bytes-bound at its narrow convs (C = 4 / Co = 16 moves
// ~17 MB of indices for ~0.5 GFLOP) and near the balance at the 64-wide ones.
//
// Design: the gather-GEMM of csrc/bykey_gemm.cuh (K4's) with the rulebook
// as its row source (`bykey::TableRows`): a block owns 64 output rows, reads
// each (tap, row) index once, compacts each tap's hits by a ballot and a
// prefix count, gathers only them, and multiplies on the tensor cores in
// split precision (3xTF32 mma.sync m16n8k8), summed in tap order without
// atomics: bit-equal on repeat. A row block whose rulebook holds no hit
// (the padding at the tail of every level: rows are key-sorted) does no
// product at all. Eleven of SECOND's twelve convs (Co <= 64) take the
// header's `raw_kernel`: rows by cp.async split by each warp as it loads
// them, one k-step a chunk at C = 4 and two at C = 16, and at Co = 16 / 32
// warps that split the row tiles so that all eight multiply; conv_out
// (Co = 128) takes `planes_kernel`. An earlier version was a CUDA-core tiled
// GEMM that multiplied a whole tile of rows for every tap with any hit.
#include "bykey_gemm.cuh"

// f (b, v, c) f32, idx (b, k, q) i32 in [0, v) or -1, w (k, c, co) f32 with
// k <= 64; out (b, q, co) f32.
extern "C" int gather_launch(const void* f, const void* idx, const void* w, int b, int v,
                             int c, int k_taps, int q, int co, void* out, void* stream) {
  if (v <= 0) return cudaErrorInvalidValue;
  const bykey::TableRows rows{static_cast<const int32_t*>(idx), v};
  return bykey::gemm_launch(static_cast<const float*>(f), rows, static_cast<const float*>(w), b,
                            v, c, k_taps, q, co, static_cast<float*>(out),
                            static_cast<cudaStream_t>(stream));
}
