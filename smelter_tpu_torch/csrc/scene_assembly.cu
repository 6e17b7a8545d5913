// K1: single-pass SDF scene assembly. Creates the channel-major premultiplied
// (4, H, W) f32 canvas of a run of colour and box-shadow members: every
// pixel starts transparent black in registers, OVER-blends each member in
// paint order, and is written once.
//
// Replaces the Pallas TPU kernel smelter_tpu/ops/pallas/scene_assembly.py
// (_kernel_body, with _blend_member, _mask_alpha_rows, _sdf, _smoothstep).
// The layer math is in sdf_common.cuh.
//
// Bound on the H100 by one 4K f32 canvas write (4 x 3840 x 2160 x 4 bytes =
// 133 MB) plus the SDF arithmetic of the pixels that members cover; nothing
// is read but the small member tables. What the design does about it:
//   - Culling is exact and per tile and per pixel, against each member's
//     clipped pixel footprint (compose._layer_region): outside it a member's
//     alpha is exactly 0, and OVER with a zero layer is the identity. A
//     32 x 32 tile skips every member whose footprint misses it with one
//     uniform branch.
//   - Pixels in a member's flat interior (its fill box: radius-, border-,
//     rotation- and mask-free colour members, shrunk by 2 px) take the flat
//     premultiplied colour and skip the SDF: there smoothstep returns
//     exactly 1, so the result is the same.
//   - The member tables stay in global memory (L1/L2-resident; every thread
//     of a warp reads the same address), which removes the TPU kernel's
//     16 KB scalar-memory bound on their size.
//   - Edge tiles of a canvas whose size is not a multiple of the tile are
//     masked per pixel.
//
// Spec row (int32, kSpecW wide): kind, has_border, has_rotation, n_masks,
// rotated-mask bits, footprint y0, x0, y1, x1 (half-open, clipped to the
// canvas), fill box y0, x0, y1, x1 (empty when y0 >= y1).

#include <cuda_runtime.h>

#include "sdf_common.cuh"

namespace {

constexpr int kSpecW = 13;
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kThreadsY = 8;
constexpr int kRows = kTileH / kThreadsY;  // pixels per thread, one column

__global__ void __launch_bounds__(kTileW * kThreadsY)
    scene_assembly_kernel(const int* __restrict__ specs,
                          const float* __restrict__ params,
                          float* __restrict__ out, int n_members,
                          int param_w, int h, int w) {
  const int tx0 = blockIdx.x * kTileW, ty0 = blockIdx.y * kTileH;
  const int tx1 = min(tx0 + kTileW, w), ty1 = min(ty0 + kTileH, h);
  const int x = tx0 + threadIdx.x;
  const float px = static_cast<float>(x) + 0.5f;

  float acc[kRows][4];
  for (int k = 0; k < kRows; ++k)
    for (int c = 0; c < 4; ++c) acc[k][c] = 0.0f;

  for (int li = 0; li < n_members; ++li) {
    const int* s = specs + li * kSpecW;
    const int ry0 = s[5], rx0 = s[6], ry1 = s[7], rx1 = s[8];
    if (ry0 >= ty1 || ry1 <= ty0 || rx0 >= tx1 || rx1 <= tx0) continue;
    if (x < rx0 || x >= rx1) continue;
    const int kind = s[0], n_masks = s[3], rotated_bits = s[4];
    const bool has_border = s[1] != 0, has_rotation = s[2] != 0;
    const int fy0 = s[9], fx0 = s[10], fy1 = s[11], fx1 = s[12];
    const float* p = params + static_cast<size_t>(li) * param_w;
    const bool x_in_fill = x >= fx0 && x < fx1;
    for (int k = 0; k < kRows; ++k) {
      const int y = ty0 + threadIdx.y + k * kThreadsY;
      if (y < ry0 || y >= ry1) continue;
      float layer[4];
      if (x_in_fill && y >= fy0 && y < fy1) {
        layer[0] = p[9] * p[12];
        layer[1] = p[10] * p[12];
        layer[2] = p[11] * p[12];
        layer[3] = p[12];
      } else {
        smelter::member_layer(p, kind, has_border, has_rotation, n_masks,
                              rotated_bits, px, static_cast<float>(y) + 0.5f,
                              layer);
      }
      smelter::over(layer, acc[k]);
    }
  }

  if (x >= tx1) return;
  const size_t plane = static_cast<size_t>(h) * w;
  for (int k = 0; k < kRows; ++k) {
    const int y = ty0 + threadIdx.y + k * kThreadsY;
    if (y >= ty1) break;
    const size_t i = static_cast<size_t>(y) * w + x;
    for (int c = 0; c < 4; ++c) out[c * plane + i] = acc[k][c];
  }
}

}  // namespace

extern "C" int smelter_scene_assembly(const void* specs, const void* params,
                                      void* out, int n_members, int spec_w,
                                      int param_w, int h, int w,
                                      void* stream) {
  if (spec_w != kSpecW || param_w < smelter::kParamsBase || n_members < 0 ||
      h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kTileW, kThreadsY);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  scene_assembly_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(specs), static_cast<const float*>(params),
      static_cast<float*>(out), n_members, param_w, h, w);
  return static_cast<int>(cudaGetLastError());
}
