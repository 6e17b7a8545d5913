// Rounded-rect SDF layer math and per-tile member classes shared by the SDF
// kernels: K1 scene_assembly and K3 sdf_layers (members without masks).
//
// Formula order mirrors smelter_tpu/ops/pallas/scene_assembly.py
// (_smoothstep, _sdf, _mask_alpha_rows, _blend_member), which with no masks
// is smelter_tpu/ops/pallas/sdf_layers.py:_layer_kernel_body, and the plain
// PyTorch version in smelter_tpu_torch/ops/hopper/scene_assembly.py, operation for
// operation: the library is built with -fmad=false and without fast math,
// so each operation rounds as the plain version's does, and sqrtf, the
// divisions and cosf/sinf are the IEEE / accurate ones. What is constant per
// member (centre, half sizes, premultiplied colours, cos and sin of the
// rotation) is computed once per block into shared memory by the same f32
// operations on the same inputs, so hoisting changes no bit.
//
// A parameter row is PARAMS_BASE + MASK_W * max_masks floats:
//   0 top, 1 left, 2 width, 3 height, 4 rotation (degrees),
//   5..8 radius [tl, tr, br, bl], 9..12 colour (straight RGBA),
//   13 border width, 14..17 border colour, 18 blur radius,
//   then per mask: radius[4], top, left, width, height, rotation (radians).
//
// Tile classes (classify; mirrored in plain PyTorch by
// smelter_tpu_torch/ops/hopper/tile_class.py, which the CPU tests hold to
// the plain layer math). For the pixel centres of a tile, a member is
//   - kOutside: its layer is exactly 0 at every one, so OVER with it is the
//     identity and the kernels skip it;
//   - kInterior: its alpha is exactly 1 at every one, so its layer is the
//     one flat value `flat` (the same operations with alpha 1.0f);
//   - kEdge: anything else; the per-pixel path.
// The proof, for radii r >= 0: outside the rect the rounded-rect SDF is at
// least the per-axis distance max(|dx| - hw, |dy| - hh); inside the rect
// shrunk by max(r) + m it is at most -m. A colour or bordered layer is 0
// where the SDF >= 0.5, a shadow where it is >= max(blur, 1) / 2, a mask's
// coverage where its SDF >= 0.5; alpha is 1 where the SDF <= -0.5 (colour),
// <= -(bwd + 1) (border) or <= -max(blur, 1) / 2 (shadow). Each test keeps
// 1 px more than that for f32 rounding, which stays far below 1 px at the
// magnitudes the premise allows (|value| <= kMaxMagnitude). A rotated
// member (or mask) uses its circumscribed circle for outside and is never
// interior; a masked member is never interior. A member whose parameters
// break a premise (non-finite or larger than kMaxMagnitude, a negative
// size, a radius outside [0, min(hw, hh)], a negative border width, a
// colour channel outside [0, 1]) is kEdge wherever its region reaches.

#pragma once

namespace smelter {

constexpr int kParamsBase = 19;
constexpr int kMaskW = 9;
constexpr int kKindColor = 0;
constexpr int kKindShadow = 1;
// (float)(pi / 180), the constant the reference multiplies in f32
constexpr float kDegToRad = static_cast<float>(3.141592653589793 / 180.0);

constexpr int kOutside = 0;
constexpr int kEdge = 1;
constexpr int kInterior = 2;
constexpr float kMaxMagnitude = 65536.0f;
constexpr int kChunk = 32;  // members per pass: one warp's ballot

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

// What a block keeps in shared memory per member.
struct MemberConst {
  float cx, cy, hw, hh;
  float r[4];               // tl, tr, br, bl
  float col[4], bcol[4];    // premultiplied colour and border colour
  float flat[4];            // the layer where alpha is exactly 1
  float cos_a, sin_a, bwd, blur;  // blur = max(blur radius, 1)
  const float* p;           // the parameter row (its masks)
  int kind, has_border, has_rotation, n_masks, rotated_bits;
  int ry0, rx0, ry1, rx1;   // region (set_region), half-open
  int ok;                   // the premises of the tile classes hold
};

__device__ __forceinline__ bool within(float v, float lo, float hi) {
  return v >= lo && v <= hi;  // false for NaN
}

// The premises of the tile classes for one rounded rect: finite, bounded,
// a size >= 0 and radii in [0, min(hw, hh)].
__device__ __forceinline__ bool rect_premise(float w, float h,
                                             const float* radius) {
  const float lim = fminf(w * 0.5f, h * 0.5f);
  bool ok = w >= 0.0f;
  ok &= h >= 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) ok &= within(radius[c], 0.0f, lim);
  return ok;
}

// The premises of a member's parameter row q (already in registers) and of
// its masks. Every load is issued before any test, so a block pays one
// memory latency for a row, not one per value.
__device__ __forceinline__ int member_premise(const float* q,
                                              const float* __restrict__ p,
                                              int n_masks) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < kParamsBase; ++i)
    ok &= within(q[i], -kMaxMagnitude, kMaxMagnitude);
#pragma unroll
  for (int i = 9; i < 18; ++i)
    if (i != 13) ok &= within(q[i], 0.0f, 1.0f);
  ok &= q[13] >= 0.0f;
  ok &= rect_premise(q[2], q[3], q + 5);
  for (int mi = 0; mi < n_masks; ++mi) {
    float m[kMaskW];
#pragma unroll
    for (int i = 0; i < kMaskW; ++i) m[i] = p[kParamsBase + mi * kMaskW + i];
#pragma unroll
    for (int i = 0; i < kMaskW; ++i)
      ok &= within(m[i], -kMaxMagnitude, kMaxMagnitude);
    ok &= rect_premise(m[6], m[7], m);
  }
  return ok;
}

__device__ __forceinline__ void load_member(const float* __restrict__ p,
                                            int kind, int has_border,
                                            int has_rotation, int n_masks,
                                            int rotated_bits, MemberConst& m) {
  float q[kParamsBase];
#pragma unroll
  for (int i = 0; i < kParamsBase; ++i) q[i] = p[i];
  const float w = q[2], h = q[3];
  m.cx = q[1] + w * 0.5f;
  m.cy = q[0] + h * 0.5f;
  m.hw = w * 0.5f;
  m.hh = h * 0.5f;
#pragma unroll
  for (int c = 0; c < 4; ++c) m.r[c] = q[5 + c];
  m.col[0] = q[9] * q[12];
  m.col[1] = q[10] * q[12];
  m.col[2] = q[11] * q[12];
  m.col[3] = q[12];
  m.bcol[0] = q[14] * q[17];
  m.bcol[1] = q[15] * q[17];
  m.bcol[2] = q[16] * q[17];
  m.bcol[3] = q[17];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    m.flat[c] = kind != kKindShadow && has_border
                    ? m.bcol[c] + (m.col[c] - m.bcol[c]) * 1.0f
                    : m.col[c];
  m.cos_a = 1.0f;
  m.sin_a = 0.0f;
  if (has_rotation) {
    const float ang = q[4] * kDegToRad;
    m.cos_a = cosf(ang);
    m.sin_a = sinf(ang);
  }
  m.bwd = q[13];
  m.blur = fmaxf(q[18], 1.0f);
  m.p = p;
  m.kind = kind;
  m.has_border = has_border;
  m.has_rotation = has_rotation;
  m.n_masks = n_masks;
  m.rotated_bits = rotated_bits;
  m.ok = member_premise(q, p, n_masks);
}

// Sets the member's region to [ry0, ry1) x [rx0, rx1) clipped to the pixels
// it can reach: beyond hw + m_out (hh + m_out) from its centre, or beyond
// its circumscribed circle's radius + 2 m_out when rotated, its layer is
// exactly 0 (the tile classes' proof), so skipping it there is exact; the
// box keeps 2 px more for rounding. A member that breaks a premise keeps
// the whole region.
__device__ __forceinline__ void set_region(MemberConst& m, int ry0, int rx0,
                                           int ry1, int rx1) {
  if (m.ok) {
    const float m_out = m.kind == kKindShadow ? m.blur * 0.5f : 0.5f;
    float ex = m.hw + m_out + 2.0f, ey = m.hh + m_out + 2.0f;
    if (m.has_rotation)
      ex = ey = sqrtf(m.hw * m.hw + m.hh * m.hh) + 2.0f * m_out + 3.0f;
    ry0 = max(ry0, static_cast<int>(floorf(m.cy - ey - 0.5f)));
    rx0 = max(rx0, static_cast<int>(floorf(m.cx - ex - 0.5f)));
    ry1 = min(ry1, static_cast<int>(ceilf(m.cy + ey - 0.5f)) + 1);
    rx1 = min(rx1, static_cast<int>(ceilf(m.cx + ex - 0.5f)) + 1);
  }
  m.ry0 = ry0;
  m.rx0 = rx0;
  m.ry1 = ry1;
  m.rx1 = rx1;
}

// The premultiplied RGBA layer of one colour or box-shadow member at pixel
// center (px, py).
__device__ __forceinline__ void member_layer(const MemberConst& m, float px,
                                             float py, float layer[4]) {
  float dx = px - m.cx;
  float dy = py - m.cy;
  if (m.has_rotation) {
    const float rdx = m.cos_a * dx + m.sin_a * dy;
    const float rdy = -m.sin_a * dx + m.cos_a * dy;
    dx = rdx;
    dy = rdy;
  }
  const float edge =
      -rounded_rect_sdf(dx, dy, m.hw, m.hh, m.r[0], m.r[1], m.r[2], m.r[3]);

  if (m.kind == kKindShadow) {
    float a = smoothstep(-m.blur * 0.5f, m.blur * 0.5f, edge);
    if (m.n_masks > 0) a = a * mask_alpha(m.p, px, py, m.n_masks, m.rotated_bits);
    for (int c = 0; c < 4; ++c) layer[c] = m.col[c] * a;
    return;
  }
  if (m.has_border) {
    const float bwd = m.bwd;
    const float border_alpha = smoothstep(bwd, bwd + 1.0f, edge);
    const float content_alpha = smoothstep(-0.5f, 0.5f, edge);
    const bool in_border = edge > bwd * 0.5f;
    for (int c = 0; c < 4; ++c) {
      layer[c] = in_border ? m.bcol[c] + (m.col[c] - m.bcol[c]) * border_alpha
                           : m.bcol[c] * content_alpha;
    }
  } else {
    const float a = smoothstep(-0.5f, 0.5f, edge);
    for (int c = 0; c < 4; ++c) layer[c] = m.col[c] * a;
  }
  if (m.n_masks > 0) {
    const float ma = mask_alpha(m.p, px, py, m.n_masks, m.rotated_bits);
    for (int c = 0; c < 4; ++c) layer[c] = layer[c] * ma;
  }
}

// Premultiplied OVER: acc = layer + acc * (1 - layer.a).
__device__ __forceinline__ void over(const float layer[4], float acc[4]) {
  const float one_minus_a = 1.0f - layer[3];
  for (int c = 0; c < 4; ++c) acc[c] = layer[c] + acc[c] * one_minus_a;
}

// Nearest and farthest |offset| from centre c of the pixel centres a0 + 0.5
// .. a1 - 0.5 (a0 < a1), rounded as the per-pixel path rounds px - c.
__device__ __forceinline__ void span(int a0, int a1, float c, float& near_,
                                     float& far_) {
  const float lo = (static_cast<float>(a0) + 0.5f) - c;
  const float hi = (static_cast<float>(a1 - 1) + 0.5f) - c;
  near_ = lo > 0.0f ? lo : (hi < 0.0f ? -hi : 0.0f);
  far_ = fmaxf(fabsf(lo), fabsf(hi));
}

// Every pixel centre of the tile lies more than `margin` + 1 px outside the
// rect (hw, hh) centred where (near_x, near_y) were measured from.
__device__ __forceinline__ bool tile_outside(float near_x, float near_y,
                                             float hw, float hh, bool rotated,
                                             float margin) {
  if (rotated) {
    const float dist = sqrtf(near_x * near_x + near_y * near_y);
    return dist >= sqrtf(hw * hw + hh * hh) + (2.0f * margin + 2.0f);
  }
  return fmaxf(near_x - hw, near_y - hh) >= margin + 1.0f;
}

// The class of member m over the pixel rect [x0, x1) x [y0, y1), non-empty
// and inside the member's region.
__device__ __forceinline__ int classify(const MemberConst& m, int x0, int x1,
                                        int y0, int y1) {
  if (!m.ok) return kEdge;
  float near_x, far_x, near_y, far_y;
  span(x0, x1, m.cx, near_x, far_x);
  span(y0, y1, m.cy, near_y, far_y);
  const bool shadow = m.kind == kKindShadow;
  const float m_out = shadow ? m.blur * 0.5f : 0.5f;
  if (tile_outside(near_x, near_y, m.hw, m.hh, m.has_rotation != 0, m_out))
    return kOutside;
  for (int mi = 0; mi < m.n_masks; ++mi) {
    const float* k = m.p + kParamsBase + mi * kMaskW;
    const float w = k[6], h = k[7];
    float mnx, mfx, mny, mfy;
    span(x0, x1, k[5] + w * 0.5f, mnx, mfx);
    span(y0, y1, k[4] + h * 0.5f, mny, mfy);
    if (tile_outside(mnx, mny, w * 0.5f, h * 0.5f, (m.rotated_bits >> mi) & 1,
                     0.5f))
      return kOutside;
  }
  if (m.has_rotation || m.n_masks > 0) return kEdge;
  const float r_max = fmaxf(fmaxf(m.r[0], m.r[1]), fmaxf(m.r[2], m.r[3]));
  const float m_in =
      shadow ? m.blur * 0.5f : (m.has_border ? m.bwd + 1.0f : 0.5f);
  const float inset = r_max + m_in + 1.0f;
  return far_x <= m.hw - inset && far_y <= m.hh - inset ? kInterior : kEdge;
}

// The classes of one pass of members (members[0..cnt), cnt <= 32) over the
// pixel rect [tx0, tx1) x [ty0, ty1) (the calling warp's rows of a tile;
// an empty rect gives no member), for the calling warp: lane i classifies
// member i over the part of the tile in its region, and the warp's ballots
// give bit i of *present (member i reaches the tile: not classed outside)
// and of *interior. Every warp of a block computes the same bits, so warps
// need not wait for each other. With kRestart, an opaque interior member
// that covers the rect (flat alpha exactly 1) drops every member under it
// from *present and the function returns true: OVER gives layer + acc * 0 =
// layer exactly for a finite acc, which holds while no member under it
// breaks a premise (`bad` carries that across passes).
template <bool kRestart>
__device__ __forceinline__ bool warp_classes(const MemberConst* members,
                                             int cnt, int tx0, int tx1,
                                             int ty0, int ty1, bool& bad,
                                             unsigned& present,
                                             unsigned& interior) {
  const int lane = (threadIdx.x + threadIdx.y * blockDim.x) & 31;
  int c = kOutside;
  bool ok = true, opaque = false;
  if (lane < cnt) {
    const MemberConst& m = members[lane];
    const int y0 = max(ty0, m.ry0), x0 = max(tx0, m.rx0);
    const int y1 = min(ty1, m.ry1), x1 = min(tx1, m.rx1);
    if (y0 < y1 && x0 < x1) c = classify(m, x0, x1, y0, y1);
    ok = m.ok != 0;
    opaque = kRestart && c == kInterior && m.flat[3] == 1.0f && m.ry0 <= ty0 &&
             m.rx0 <= tx0 && m.ry1 >= ty1 && m.rx1 >= tx1;
  }
  unsigned pm = __ballot_sync(0xffffffffu, c != kOutside);
  const unsigned bm = __ballot_sync(0xffffffffu, c != kOutside && !ok);
  const unsigned om = __ballot_sync(0xffffffffu, opaque);
  interior = __ballot_sync(0xffffffffu, c == kInterior);
  bool restart = false;
  if (kRestart && !bad) {
    const unsigned under_bad = bm ? (1u << (__ffs(bm) - 1)) - 1u : 0xffffffffu;
    const unsigned cand = om & under_bad;
    if (cand) {
      pm &= ~((1u << (31 - __clz(cand))) - 1u);
      restart = true;
    }
  }
  bad = bad || (pm & bm) != 0u;
  present = pm;
  return restart;
}

// Blocks of a persistent grid over `blocks` blocks' worth of work: as many
// as are resident on the card's SMs at once, and no more than `blocks`.
// The residency is read once per (kTag, Kernel type): instances of one
// kernel template share a type, so each passes its own tag.
template <int kTag = 0, typename Kernel>
inline int persistent_grid(Kernel kernel, int threads, int blocks) {
  static int resident = 0;
  if (resident <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      0) == cudaSuccess) {
      resident = sms * per_sm;
    }
    if (resident <= 0) return blocks;
  }
  return blocks < resident ? blocks : resident;
}

}  // namespace smelter
