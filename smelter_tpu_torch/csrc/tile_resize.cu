// The resize of YUV420 tiles into the three f32 products kernel K4 reads, in
// one launch for every tile of a run: u8 planes in, each tile's Y, U and V
// products at luma resolution out.
//
// For each static YUV texture the JAX package's general route computes
// color_convert.yuv_tile_rgba_cm (smelter_tpu/ops/color_convert.py): the
// luma crop and the whole chroma planes resized by two matmuls each, the
// chroma ones by the Lanczos-3 matrix composed with the 2x bilinear upsample
// (the crop folded into it), and XLA fuses the casts, the matmuls and the
// colour tail into the frame program. There is no Pallas kernel for it:
// this kernel stands for the resizes of that fusion (K4 applies the colour
// tail). Its arithmetic, as color_convert._rs:
//   1. a height pass: for each output row the f32 sum of bf16 weight x u8
//      sample over the row's band, rounded to bf16 (nearest even);
//   2. a width pass over those bf16 values, an f32 sum kept in f32 and
//      written as it is.
// Both passes always run, with the weights of color_convert.tile_weights
// (an axis of unchanged size included, as the GEMM route multiplies it).
//
// The weights are those four bf16 matrices, each row cut to its band of
// nonzero columns (grid_resize.matrix_band, tile_resize.tile_band); the
// products are those of the GEMM route on the same bf16 operands, summed in
// f32 on the tensor cores; only products by an exact zero are skipped.
//
// Bound on the H100 by bytes: each input sample read once and each f32
// product written once (the styled 16 x 1080p -> 4K multiview: 49.8 MB in,
// about 94 MB out, about 0.043 ms at 3.35 TB/s). The dense GEMMs it replaces
// (six a tile, and the u8 -> bf16 casts of their operands) multiplied
// mostly by zeros, at shapes whose widths are no multiple of 8. The design
// is banded_resize.cuh's, shared with grid_resize.cu: persistent blocks over
// strips of one tile plane, the window and the weights copied with cp.async
// a strip ahead, tensor-core height and width passes; each output pair is
// stored as two f32 into its tile plane's own output.

#include "banded_resize.cuh"

namespace {

struct TileArgs {
  const uint8_t* src[kMaxPlanes];  // each tile plane's source (the luma crop's origin, a whole chroma plane)
  int src_stride[kMaxPlanes];      // bytes between source rows
  float* dst[kMaxPlanes];          // each tile plane's products
  int dst_stride[kMaxPlanes];      // floats between their rows
  StripArgs s;

  // a strip row's output plane is its tile plane
  __device__ int dst_index(const int* d) const { return d[kDst] - s.first; }
};

__global__ void __launch_bounds__(kThreads, 3) tile_resize_kernel(const TileArgs args) {
  resize_strips(args);
}

}  // namespace

// src, src_stride, dst, dst_stride: n host arrays, the launch's tile planes'
// sources and bytes between their rows, and their f32 outputs and floats
// between their rows, tile plane `first` of the table first; table: the
// device table; strips, n_strips: the table's row of the launch's first
// strip and their number; hpad, wpad, mrows, h_ints, w_ints: the launch's
// largest strip (shared memory layout, `smem_bytes` in all); blocks: the
// persistent blocks to launch (smelter_tile_resize_blocks_per_sm a card's
// SM, at most one a strip). Returns the launch's cudaError_t.
extern "C" int smelter_tile_resize(const void* const* src, const int* src_stride,
                                   void* const* dst, const int* dst_stride, int n,
                                   const void* table, int first, int strips, int n_strips,
                                   int hpad, int wpad, int mrows, int h_ints, int w_ints,
                                   int smem_bytes, int blocks, void* stream) {
  if (!strip_args_valid(n, n_strips, strips, first, hpad, wpad, mrows, h_ints, w_ints,
                        smem_bytes, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TileArgs args;
  std::memset(&args, 0, sizeof(args));
  for (int i = 0; i < n; ++i) {
    args.src[i] = static_cast<const uint8_t*>(src[i]);
    args.src_stride[i] = src_stride[i];
    args.dst[i] = static_cast<float*>(dst[i]);
    args.dst_stride[i] = dst_stride[i];
  }
  args.s = StripArgs{static_cast<const int*>(table), strips, n_strips, first,
                     hpad, wpad, mrows, h_ints, w_ints};
  tile_resize_kernel<<<blocks, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of tile_resize_kernel an SM of the current card holds at
// `smem_bytes` of dynamic shared memory, or -1 (banded_resize.cuh's
// blocks_per_sm). Call it on each card before its first launch, outside a
// CUDA graph's capture.
extern "C" int smelter_tile_resize_blocks_per_sm(int smem_bytes) {
  return blocks_per_sm(tile_resize_kernel, smem_bytes);
}
