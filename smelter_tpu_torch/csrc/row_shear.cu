// K5: one static width shear of the Paeth three-shear rotation in one pass.
// out[c, r, x] = src[c, r, x - i_r] * (1 - f_r) + src[c, r, x - i_r - 1] * f_r,
// zero outside the source, with i_r = floor(d_r), f_r = (float)(d_r - i_r),
// d_r = k * (r + 0.5 - rows / 2) in f64: rotate._shear_w's result
// (smelter_tpu_torch/ops/rotate.py), whose barrel shifter moves row r right
// by i_r + bias in whole-pixel steps, one per bit of the shift, and then
// blends each pixel with its left neighbour. The height shear
// (rotate._shear_h) is the same pass along the other axis, read through the
// source's strides: no transposed copy is made. d_r, i_r and f_r are
// computed here by the f64 operations of rotate._shear_rows, in its order,
// so they are its numbers, and the blend is its two products and one sum
// (-fmad=false keeps them apart): the kernel equals the barrel bit for bit.
//
// Stands for the barrel shear of smelter_tpu/ops/rotate.py (_shear_w,
// _shear_h), which the JAX package runs as XLA's fusion of its pads and
// selects: a TPU device, built because the TPU gathers badly. Its arithmetic
// is one integer shift and one two-tap blend a pixel; the card gathers
// well, so each output pixel reads its two source pixels directly.
//
// Bound on the H100 by bytes: each source pixel read once and each output
// pixel written once, 8 bytes a pixel a channel in f32. Design: one thread
// per output pixel, threads of a warp along x (the shear along x reads
// neighbouring addresses; the shear along y reads one row a thread, whose
// shift changes with x), the row's shift recomputed per thread in f64
// (a few instructions against two loads), and one plane a grid layer.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockX = 64;
constexpr int kBlockY = 4;

__global__ void __launch_bounds__(kBlockX* kBlockY)
    row_shear_kernel(const float* __restrict__ src, float* __restrict__ out,
                     int h, int w, long long s_c, long long s_y, long long s_x,
                     double k, int along_x) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int c = blockIdx.z;
  // the row whose shift this pixel takes, and its place along the shift
  const int r = along_x ? y : x;
  const int rows = along_x ? h : w;
  const long long pos = along_x ? x : y;
  const long long n = along_x ? w : h;
  const double d = k * ((static_cast<double>(r) + 0.5) - static_cast<double>(rows) / 2.0);
  const double fl = floor(d);
  const long long i = static_cast<long long>(fl);
  const float f = static_cast<float>(d - fl);
  const long long p0 = pos - i, p1 = p0 - 1;
  const float* plane = src + c * s_c;
  const long long step = along_x ? s_x : s_y;
  const float* line = plane + (along_x ? y * s_y : x * s_x);
  const float a = p0 >= 0 && p0 < n ? line[p0 * step] : 0.0f;
  const float b = p1 >= 0 && p1 < n ? line[p1 * step] : 0.0f;
  out[(static_cast<size_t>(c) * h + y) * w + x] = a * (1.0f - f) + b * f;
}

}  // namespace

// src: (c, h, w) f32 at element strides (s_c, s_y, s_x); out: (c, h, w) f32,
// contiguous. along_x: 1 for the width shear (rows are y), 0 for the height
// shear (rows are x). Returns the launch's cudaError_t.
extern "C" int smelter_row_shear(const void* src, void* out, int c, int h, int w,
                                 long long s_c, long long s_y, long long s_x,
                                 double k, int along_x, void* stream) {
  if (c <= 0 || h <= 0 || w <= 0 || c > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, c);
  row_shear_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(out), h, w, s_c, s_y,
      s_x, k, along_x);
  return static_cast<int>(cudaGetLastError());
}
