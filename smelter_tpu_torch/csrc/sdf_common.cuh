// Rounded-rect SDF layer math shared by the SDF kernels: K1 scene_assembly
// and K3 sdf_layers (which calls member_layer with no masks).
//
// Formula order mirrors smelter_tpu/ops/pallas/scene_assembly.py
// (_smoothstep, _sdf, _mask_alpha_rows, _blend_member), which with no masks
// is smelter_tpu/ops/pallas/sdf_layers.py:_layer_kernel_body, and the plain
// PyTorch version in smelter_tpu_torch/ops/hopper/scene_assembly.py, operation for
// operation: the library is built with -fmad=false and without fast math,
// so each operation rounds as the plain version's does, and sqrtf, the
// divisions and cosf/sinf are the IEEE / accurate ones.
//
// A parameter row is PARAMS_BASE + MASK_W * max_masks floats:
//   0 top, 1 left, 2 width, 3 height, 4 rotation (degrees),
//   5..8 radius [tl, tr, br, bl], 9..12 colour (straight RGBA),
//   13 border width, 14..17 border colour, 18 blur radius,
//   then per mask: radius[4], top, left, width, height, rotation (radians).

#pragma once

namespace smelter {

constexpr int kParamsBase = 19;
constexpr int kMaskW = 9;
constexpr int kKindColor = 0;
constexpr int kKindShadow = 1;
// (float)(pi / 180), the constant the reference multiplies in f32
constexpr float kDegToRad = static_cast<float>(3.141592653589793 / 180.0);

__device__ __forceinline__ float smoothstep(float e0, float e1, float x) {
  float t = (x - e0) / fmaxf(e1 - e0, 1e-6f);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  return t * t * (3.0f - 2.0f * t);
}

__device__ __forceinline__ float rounded_rect_sdf(float dx, float dy,
                                                  float half_w, float half_h,
                                                  float r_tl, float r_tr,
                                                  float r_br, float r_bl) {
  const float r_top = dx < 0.0f ? r_tl : r_tr;
  const float r_bottom = dx < 0.0f ? r_bl : r_br;
  const float r = dy < 0.0f ? r_top : r_bottom;
  const float qx = fabsf(dx) - half_w + r;
  const float qy = fabsf(dy) - half_h + r;
  const float qx_pos = fmaxf(qx, 0.0f);
  const float qy_pos = fmaxf(qy, 0.0f);
  return fminf(fmaxf(qx, qy), 0.0f) + sqrtf(qx_pos * qx_pos + qy_pos * qy_pos) -
         r;
}

// Product of the parent masks' coverage at (px, py); n_masks >= 1.
__device__ __forceinline__ float mask_alpha(const float* __restrict__ p,
                                            float px, float py, int n_masks,
                                            int rotated_bits) {
  float alpha = 1.0f;
  for (int mi = 0; mi < n_masks; ++mi) {
    const float* m = p + kParamsBase + mi * kMaskW;
    const float w = m[6], h = m[7];
    const float cx = m[5] + w * 0.5f;
    const float cy = m[4] + h * 0.5f;
    float dx = px - cx;
    float dy = py - cy;
    if ((rotated_bits >> mi) & 1) {
      const float ca = cosf(m[8]), sa = sinf(m[8]);
      const float rdx = ca * dx + sa * dy;
      const float rdy = -sa * dx + ca * dy;
      dx = rdx;
      dy = rdy;
    }
    const float d = rounded_rect_sdf(dx, dy, w * 0.5f, h * 0.5f, m[0], m[1],
                                     m[2], m[3]);
    const float a = smoothstep(-0.5f, 0.5f, -d);
    alpha = mi == 0 ? a : alpha * a;
  }
  return alpha;
}

// The premultiplied RGBA layer of one colour or box-shadow member at pixel
// center (px, py).
__device__ __forceinline__ void member_layer(const float* __restrict__ p,
                                             int kind, bool has_border,
                                             bool has_rotation, int n_masks,
                                             int rotated_bits, float px,
                                             float py, float layer[4]) {
  const float w = p[2], h = p[3];
  const float cx = p[1] + w * 0.5f;
  const float cy = p[0] + h * 0.5f;
  float dx = px - cx;
  float dy = py - cy;
  if (has_rotation) {
    const float ang = p[4] * kDegToRad;
    const float cos_a = cosf(ang), sin_a = sinf(ang);
    const float rdx = cos_a * dx + sin_a * dy;
    const float rdy = -sin_a * dx + cos_a * dy;
    dx = rdx;
    dy = rdy;
  }
  const float edge =
      -rounded_rect_sdf(dx, dy, w * 0.5f, h * 0.5f, p[5], p[6], p[7], p[8]);
  const float col[4] = {p[9] * p[12], p[10] * p[12], p[11] * p[12], p[12]};

  if (kind == kKindShadow) {
    const float blur = fmaxf(p[18], 1.0f);
    float a = smoothstep(-blur * 0.5f, blur * 0.5f, edge);
    if (n_masks > 0) a = a * mask_alpha(p, px, py, n_masks, rotated_bits);
    for (int c = 0; c < 4; ++c) layer[c] = col[c] * a;
    return;
  }
  if (has_border) {
    const float bwd = p[13];
    const float bcol[4] = {p[14] * p[17], p[15] * p[17], p[16] * p[17], p[17]};
    const float border_alpha = smoothstep(bwd, bwd + 1.0f, edge);
    const float content_alpha = smoothstep(-0.5f, 0.5f, edge);
    const bool in_border = edge > bwd * 0.5f;
    for (int c = 0; c < 4; ++c) {
      layer[c] = in_border ? bcol[c] + (col[c] - bcol[c]) * border_alpha
                           : bcol[c] * content_alpha;
    }
  } else {
    const float a = smoothstep(-0.5f, 0.5f, edge);
    for (int c = 0; c < 4; ++c) layer[c] = col[c] * a;
  }
  if (n_masks > 0) {
    const float m = mask_alpha(p, px, py, n_masks, rotated_bits);
    for (int c = 0; c < 4; ++c) layer[c] = layer[c] * m;
  }
}

// Premultiplied OVER: acc = layer + acc * (1 - layer.a).
__device__ __forceinline__ void over(const float layer[4], float acc[4]) {
  const float one_minus_a = 1.0f - layer[3];
  for (int c = 0; c < 4; ++c) acc[c] = layer[c] + acc[c] * one_minus_a;
}

}  // namespace smelter
