// K4: by-key sparse-conv gather-GEMM, with the rulebook probe fused in.
//
// Replaces the Pallas TPU kernel `_bykey_kernel` of
// tsm_det_pointcloud_tpu/ops/spconv_pallas.py:132 (its pallas_call at :358):
//   out[b, q, :] = sum_k  W[k]^T . f[b, row(skeys[b] == qkeys[b, k, q]), :]
// where a key that is not found (or is >= sentinel) contributes zero.
//
// Bounds, counting the hits only (2 C Co operations a hit): float32 outside
// the tensor cores (67 TFLOP/s), and the 3xTF32 rate this kernel runs at
// (495 / 3 = 165 TFLOP/s); at the main path's widths (C, Co in {64, 128},
// 256 in the teacher's U-Net) both are above the bytes. Measured on the four
// TSM paths' calls (chip_smoke.py): only 29% (KITTI) and 43% (Waymo) of the
// rows in the (64-row block, tap) pairs with a hit are hits, 19-28 a pair.
//
// Design: the gather-GEMM of csrc/bykey_gemm.cuh with the probe as its row
// source (`bykey::ProbeRows`): every (tap, row) of a 64-row block is probed
// once, a branchless binary search, eight in flight a thread; the hits are
// compacted and multiplied on the tensor cores in split precision (3xTF32,
// float32-level error; TF32 alone does not keep it, and build_network keeps
// TF32 off), summed in tap order, bit-equal on repeat. Measured against
// variants on the Waymo training step's calls (row blocks of 128, column
// groups of 128, three stages, 16 warps for 256 columns, the three products
// of all tiles in three passes: each slower), what holds it back is the
// product loop's instruction rate and latency at the occupancy its registers
// and shared memory leave, not the weight slices' L2 traffic.
#include "bykey_gemm.cuh"

// f (b, v, c) f32, skeys (b, v) i32 ascending, qkeys (b, k, q) i32,
// w (k, c, co) f32; out (b, q, co) f32.
extern "C" int bykey_launch(const void* f, const void* skeys, const void* qkeys, const void* w,
                            int b, int v, int c, int k_taps, int q, int co, int sentinel,
                            void* out, void* stream) {
  if (v <= 0) return cudaErrorInvalidValue;
  const bykey::ProbeRows rows{static_cast<const int32_t*>(skeys),
                              static_cast<const int32_t*>(qkeys), v, sentinel};
  return bykey::gemm_launch(static_cast<const float*>(f), rows, static_cast<const float*>(w), b,
                            v, c, k_taps, q, co, static_cast<float*>(out),
                            static_cast<cudaStream_t>(stream));
}
