// The resize and placement of every tile plane of an opaque YUV420 grid in
// one launch: u8 planes in, u8 tiles written in place in the output planes.
//
// For each tile plane, the JAX package's grid route computes
// _round_u8(resize_matmul(plane, h, w)) (smelter_tpu/render/program.py's YUV
// grid program) and XLA fuses the casts, the two resize matmuls, the
// rounding and the concatenation of the tiles into one program. There is no
// Pallas kernel for it: this kernel stands for that fusion. Its arithmetic,
// as in resample.resize_matmul and flagship._round_u8:
//   1. a height pass, where in_h != out_h: for each output row the f32 sum of
//      bf16 weight x u8 sample over the row's band, rounded to bf16 (nearest
//      even);
//   2. a width pass, where in_w != out_w, over those bf16 values, again an
//      f32 sum rounded to bf16;
//   3. u8 by +0.5 in f32, a clamp to [0, 255] and truncation.
// An axis whose size does not change is skipped, as resize_matmul skips it:
// its band is one tap of weight 1, which leaves every value as it is.
//
// The weights are the bf16 Lanczos-3 matrices of the GEMM route
// (resample._dense_axis_weights rounded to bf16), stored per output row as
// a band: the first source index, then the row's weights from there, padded
// with exact zeros to the widest row of the axis (grid_resize.axis_band).
// The products are those of the GEMM route on the same bf16 operands, summed
// in f32 on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate)
// as cuBLAS sums them; only products by an exact zero are skipped.
//
// Bound on the H100 by bytes: each input sample read once and each output
// sample written once (a 4K frame of 16 tiles: 49.8 MB in, 12.4 MB out,
// 0.0186 ms at 3.35 TB/s); the useful products are about 1 GFLOP a 4K frame,
// two orders below the tensor cores' line. The dense GEMMs it replaces read
// and wrote each pixel about ten times (casts, bf16 products, rounding,
// concatenation) and multiplied mostly by zeros. The design, shared with
// tile_resize.cu, is banded_resize.cuh's: persistent blocks over strips of
// one tile plane, the u8 window and the weights copied with cp.async a strip
// ahead, tensor-core height and width passes; the u8 samples are stored
// straight into the output plane at the tile's place. What holds it below
// the bound now is each strip's chain of phases between barriers (copy,
// widen, height, width), about equal in cycles.

#include "banded_resize.cuh"

namespace {

struct GridArgs {
  const uint8_t* src[kMaxPlanes];  // each tile plane's source at its crop's origin
  int src_stride[kMaxPlanes];      // bytes between source rows
  uint8_t* dst[3];                 // the output Y, U and V planes
  int dst_stride[3];
  StripArgs s;

  __device__ int dst_index(const int* d) const { return d[kDst]; }
};

__global__ void __launch_bounds__(kThreads, 3) grid_resize_kernel(const GridArgs args) {
  resize_strips(args);
}

}  // namespace

// src, src_stride: n host arrays, the launch's tile planes' sources (at their
// crops' origins) and bytes between their rows, tile plane `first` of the
// table first; dst_y, dst_u, dst_v and dst_stride (3 host ints): the output
// planes; table: the device table; strips, n_strips: the table's row of the
// launch's first strip and their number; hpad, wpad, mrows, h_ints, w_ints:
// the launch's largest strip (shared memory layout, `smem_bytes` in all);
// blocks: the persistent blocks to launch (smelter_grid_resize_blocks_per_sm
// a card's SM, at most one a strip). Returns the launch's cudaError_t.
extern "C" int smelter_grid_resize(const void* const* src, const int* src_stride, int n,
                                   void* dst_y, void* dst_u, void* dst_v,
                                   const int* dst_stride, const void* table, int first,
                                   int strips, int n_strips, int hpad, int wpad, int mrows,
                                   int h_ints, int w_ints, int smem_bytes, int blocks,
                                   void* stream) {
  if (!strip_args_valid(n, n_strips, strips, first, hpad, wpad, mrows, h_ints, w_ints,
                        smem_bytes, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GridArgs args;
  std::memset(&args, 0, sizeof(args));
  for (int i = 0; i < n; ++i) {
    args.src[i] = static_cast<const uint8_t*>(src[i]);
    args.src_stride[i] = src_stride[i];
  }
  args.dst[0] = static_cast<uint8_t*>(dst_y);
  args.dst[1] = static_cast<uint8_t*>(dst_u);
  args.dst[2] = static_cast<uint8_t*>(dst_v);
  std::memcpy(args.dst_stride, dst_stride, sizeof(int) * 3);
  args.s = StripArgs{static_cast<const int*>(table), strips, n_strips, first,
                     hpad, wpad, mrows, h_ints, w_ints};
  grid_resize_kernel<<<blocks, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of grid_resize_kernel an SM of the current card holds at
// `smem_bytes` of dynamic shared memory, or -1 (banded_resize.cuh's
// blocks_per_sm). Call it on each card before its first launch, outside a
// CUDA graph's capture.
extern "C" int smelter_grid_resize_blocks_per_sm(int smem_bytes) {
  return blocks_per_sm(grid_resize_kernel, smem_bytes);
}
