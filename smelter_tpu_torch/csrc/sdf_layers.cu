// K3: fused full-canvas SDF layers. OVER-blends a run of L colour,
// bordered-colour and box-shadow layers onto an existing channel-major
// premultiplied (4, H, W) f32 canvas: every pixel is read once, blends each
// layer in paint order in registers, and is written once, in place.
//
// Replaces the Pallas TPU kernel smelter_tpu/ops/pallas/sdf_layers.py
// (_layer_kernel_body, launched by _compose_call). The layer math is in
// sdf_common.cuh (member_layer with no masks), which is the reference body
// operation for operation.
//
// Bound on the H100 by memory: at 4K one read and one write of the
// 4 x 3840 x 2160 x 4 = 133 MB canvas, against a few dozen flops per pixel
// and layer. What the design does about it:
//   - One thread per pixel; neighbouring threads hold neighbouring x, so
//     each of the four plane loads and stores of a warp is one coalesced
//     128-byte line.
//   - The canvas is updated in place (each pixel is read and written by the
//     same thread), so no second 133 MB buffer is allocated or written.
//   - The parameter rows (19 floats) and kind rows (3 ints) stay in global
//     memory: every thread of a warp reads the same address, so they are
//     served from L1 as broadcasts.
//   - Any H and W: the last row and column of blocks are masked per pixel.
//
// Parameter row (f32, kParamsBase = 19 wide, the order of the reference's
// pack_layer_params_traced): 0 top, 1 left, 2 width, 3 height, 4 rotation
// (degrees), 5..8 radius [tl, tr, br, bl], 9..12 colour (straight RGBA),
// 13 border width, 14..17 border colour, 18 blur radius.
// Kind row (int32, kKindW wide): content (0 colour, 1 box shadow),
// has_border, has_rotation.

#include <cuda_runtime.h>

#include "sdf_common.cuh"

namespace {

constexpr int kKindW = 3;
constexpr int kBlockW = 32;
constexpr int kBlockH = 8;

__global__ void __launch_bounds__(kBlockW * kBlockH)
    sdf_layers_kernel(float* __restrict__ canvas,
                      const float* __restrict__ params,
                      const int* __restrict__ kinds, int n_layers, int h,
                      int w) {
  const int x = blockIdx.x * kBlockW + threadIdx.x;
  const int y = blockIdx.y * kBlockH + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t i = static_cast<size_t>(y) * w + x;
  float acc[4];
  for (int c = 0; c < 4; ++c) acc[c] = canvas[c * plane + i];

  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  for (int li = 0; li < n_layers; ++li) {
    const int* k = kinds + li * kKindW;
    const float* p = params + static_cast<size_t>(li) * smelter::kParamsBase;
    float layer[4];
    smelter::member_layer(p, k[0], k[1] != 0, k[2] != 0, /*n_masks=*/0, 0, px,
                          py, layer);
    smelter::over(layer, acc);
  }

  for (int c = 0; c < 4; ++c) canvas[c * plane + i] = acc[c];
}

}  // namespace

extern "C" int smelter_sdf_layers(void* canvas, const void* params,
                                  const void* kinds, int n_layers, int h,
                                  int w, void* stream) {
  if (n_layers < 0 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (h + kBlockH - 1) / kBlockH);
  sdf_layers_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(canvas), static_cast<const float*>(params),
      static_cast<const int*>(kinds), n_layers, h, w);
  return static_cast<int>(cudaGetLastError());
}
