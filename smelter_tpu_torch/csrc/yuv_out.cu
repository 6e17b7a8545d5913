// K2: channel-major premultiplied RGBA canvas -> BT.709 YUV420 u8 planes, in
// one pass. The canvas is f32 or 16-bit storage (u16 fixed point, f16, bf16;
// smelter_tpu_torch/ops/color_convert.py canvas_decode), decoded in
// registers: the colour matrix runs in f32 either way.
//
// Replaces the Pallas TPU kernel smelter_tpu/ops/pallas/yuv_out.py
// (_kernel_body, with _pair_pool and _u8). Math order mirrors
// smelter_tpu_torch/ops/color_convert.py: rgb_planes_to_yuv, then the
// per-pixel clip to [0, 1], then the 2x2 chroma mean summed in window order
// ((a00 + a01) + a10) + a11 and scaled by 0.25, then round half to even
// (rintf) and clip to [0, 255].
//
// Bound on the H100 by memory bandwidth: it reads 3 of the canvas's 4 planes
// (alpha is never read; 12 bytes a pixel in f32, 6 in 16 bits) and writes
// 1.5 bytes a pixel. Its design follows from that: one thread per 2x2 quad
// reads the quad's 12 values once, writes the 4 Y values and one U and one V
// value, and neighbouring threads touch neighbouring addresses. The
// full-resolution U and V planes that the unfused chain writes and reads back
// never exist. A 16-bit canvas with W % 4 == 0 on an 8-byte boundary goes to
// a second kernel, one thread per two quads side by side, which loads 8
// bytes (4 pixels) of a row of a plane at once; other 16-bit canvases take
// the quad kernel.
//
// Any H and W are taken. Odd edges follow the VALID semantics of the
// reference chain: Y is full size, chroma is (H/2, W/2) rounded down, so a
// last odd row or column feeds Y only.

#include <cstdint>
#include <cuda_runtime.h>

#include "canvas_codec.cuh"

namespace {

// Every constant is the Python double of the reference rounded once to f32,
// as PyTorch and JAX round a Python scalar against an f32 tensor.
constexpr float kYScale = static_cast<float>(219.0 / 255.0);
constexpr float kUvScale = static_cast<float>(224.0 / 255.0);
constexpr float kFootroom = static_cast<float>(16.0 / 255.0);
constexpr float kHalfUvScale = static_cast<float>(0.5 * (224.0 / 255.0));
constexpr float kYr = static_cast<float>(0.2126), kYg = static_cast<float>(0.7152),
                kYb = static_cast<float>(0.0722);
constexpr float kUr = static_cast<float>(-0.1146), kUg = static_cast<float>(0.3854);
constexpr float kVg = static_cast<float>(0.4542), kVb = static_cast<float>(0.0458);

// canvas storage, by the code the entry takes (yuv_out.IN_DTYPES), decoded
// as canvas_decode decodes it
using smelter::kF32;
using smelter::kU16;
using smelter::kF16;
using smelter::kBF16;
using smelter::Storage;
using smelter::decode;

// NaN passes through, as through torch.clamp and jnp.clip, so that a quad
// holding NaN gives NaN chroma (then u8 0) as the plain version does;
// fmaxf(NaN, 0) would be 0 and the quad's mean finite
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

__device__ __forceinline__ uint8_t to_u8(float x) {
  // rintf rounds half to even, as torch.round and jnp.round do; NaN gives
  // 0, as a NaN cast to u8 gives in torch and XLA
  float q = fminf(fmaxf(rintf(x * 255.0f), 0.0f), 255.0f);
  return static_cast<uint8_t>(q);
}

struct Yuv {
  float y, u, v;
};

__device__ __forceinline__ Yuv pixel_yuv(float r, float g, float b,
                                         bool full_range) {
  float y = kYr * r + kYg * g + kYb * b;
  float u = kUr * r - kUg * g + 0.5f * b + 0.5f;
  float v = 0.5f * r - kVg * g - kVb * b + 0.5f;
  if (!full_range) {
    y = y * kYScale + kFootroom;
    u = (u - 0.5f) * kUvScale + kHalfUvScale + kFootroom;
    v = (v - 0.5f) * kUvScale + kHalfUvScale + kFootroom;
  }
  return {clip01(y), clip01(u), clip01(v)};
}

// The 2x2 chroma mean, summed in window order ((a00 + a01) + a10) + a11.
__device__ __forceinline__ float quad_mean(float a00, float a01, float a10,
                                           float a11) {
  float s = a00 + a01;
  s = s + a10;
  s = s + a11;
  return s * 0.25f;
}

template <int kIn>
__global__ void yuv420_out_kernel(const typename Storage<kIn>::T* __restrict__ rgba,
                                  uint8_t* __restrict__ y_out,
                                  uint8_t* __restrict__ u_out,
                                  uint8_t* __restrict__ v_out, int h, int w,
                                  bool full_range) {
  using T = typename Storage<kIn>::T;
  const int qx = blockIdx.x * blockDim.x + threadIdx.x;
  const int qy = blockIdx.y * blockDim.y + threadIdx.y;
  const int x0 = 2 * qx, y0 = 2 * qy;
  if (x0 >= w || y0 >= h) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const T* r_pl = rgba;
  const T* g_pl = rgba + plane;
  const T* b_pl = rgba + 2 * plane;

  float us[2][2], vs[2][2];
  for (int dy = 0; dy < 2; ++dy) {
    for (int dx = 0; dx < 2; ++dx) {
      const int yy = y0 + dy, xx = x0 + dx;
      if (yy >= h || xx >= w) continue;
      const size_t i = static_cast<size_t>(yy) * w + xx;
      const Yuv p = pixel_yuv(decode<kIn>(r_pl[i]), decode<kIn>(g_pl[i]),
                              decode<kIn>(b_pl[i]), full_range);
      y_out[i] = to_u8(p.y);
      us[dy][dx] = p.u;
      vs[dy][dx] = p.v;
    }
  }
  const int cw = w / 2;
  if (qx < cw && qy < h / 2) {
    const size_t c = static_cast<size_t>(qy) * cw + qx;
    u_out[c] = to_u8(quad_mean(us[0][0], us[0][1], us[1][0], us[1][1]));
    v_out[c] = to_u8(quad_mean(vs[0][0], vs[0][1], vs[1][0], vs[1][1]));
  }
}

__device__ __forceinline__ uint16_t lo16(uint32_t x) {
  return static_cast<uint16_t>(x & 0xffffu);
}

__device__ __forceinline__ uint16_t hi16(uint32_t x) {
  return static_cast<uint16_t>(x >> 16);
}

// A 16-bit canvas with W % 4 == 0 and 8-byte aligned planes: one thread per
// 4 x 2 pixels (two quads side by side), each row of each plane one 8-byte
// load; Y stored 4 bytes a row, U and V 2 bytes. An odd last row feeds Y
// only, as in the quad kernel.
template <int kIn>
__global__ void yuv420_out_vec4_kernel(const uint16_t* __restrict__ rgba,
                                       uint8_t* __restrict__ y_out,
                                       uint8_t* __restrict__ u_out,
                                       uint8_t* __restrict__ v_out, int h,
                                       int w, bool full_range) {
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  const int qy = blockIdx.y * blockDim.y + threadIdx.y;
  const int x0 = 4 * bx, y0 = 2 * qy;
  if (x0 >= w || y0 >= h) return;
  const size_t plane = static_cast<size_t>(h) * w;
  float us[2][4], vs[2][4];  // in registers: both loops unroll
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int yy = y0 + dy;
    if (yy >= h) continue;
    const size_t i = static_cast<size_t>(yy) * w + x0;
    const uint2 r = *reinterpret_cast<const uint2*>(rgba + i);
    const uint2 g = *reinterpret_cast<const uint2*>(rgba + plane + i);
    const uint2 b = *reinterpret_cast<const uint2*>(rgba + 2 * plane + i);
    // little endian: the pixel at the lower address in the low half
    const uint16_t rv[4] = {lo16(r.x), hi16(r.x), lo16(r.y), hi16(r.y)};
    const uint16_t gv[4] = {lo16(g.x), hi16(g.x), lo16(g.y), hi16(g.y)};
    const uint16_t bv[4] = {lo16(b.x), hi16(b.x), lo16(b.y), hi16(b.y)};
    uint8_t ys[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Yuv p = pixel_yuv(decode<kIn>(rv[k]), decode<kIn>(gv[k]),
                              decode<kIn>(bv[k]), full_range);
      ys[k] = to_u8(p.y);
      us[dy][k] = p.u;
      vs[dy][k] = p.v;
    }
    *reinterpret_cast<uchar4*>(y_out + i) = make_uchar4(ys[0], ys[1], ys[2], ys[3]);
  }
  if (qy < h / 2) {
    const size_t c = static_cast<size_t>(qy) * (w / 2) + 2 * bx;
    *reinterpret_cast<uchar2*>(u_out + c) = make_uchar2(
        to_u8(quad_mean(us[0][0], us[0][1], us[1][0], us[1][1])),
        to_u8(quad_mean(us[0][2], us[0][3], us[1][2], us[1][3])));
    *reinterpret_cast<uchar2*>(v_out + c) = make_uchar2(
        to_u8(quad_mean(vs[0][0], vs[0][1], vs[1][0], vs[1][1])),
        to_u8(quad_mean(vs[0][2], vs[0][3], vs[1][2], vs[1][3])));
  }
}

template <int kIn>
cudaError_t launch(const void* rgba, uint8_t* y, uint8_t* u, uint8_t* v,
                   int h, int w, bool full_range, cudaStream_t stream) {
  const dim3 block(32, 8);
  const int grid_y = (h + 2 * 8 - 1) / (2 * 8);
  if constexpr (kIn != kF32) {
    if (w % 4 == 0 && reinterpret_cast<uintptr_t>(rgba) % 8 == 0) {
      const dim3 grid((w + 4 * 32 - 1) / (4 * 32), grid_y);
      yuv420_out_vec4_kernel<kIn><<<grid, block, 0, stream>>>(
          static_cast<const uint16_t*>(rgba), y, u, v, h, w, full_range);
      return cudaGetLastError();
    }
  }
  const dim3 grid((w + 2 * 32 - 1) / (2 * 32), grid_y);
  yuv420_out_kernel<kIn><<<grid, block, 0, stream>>>(
      static_cast<const typename Storage<kIn>::T*>(rgba), y, u, v, h, w,
      full_range);
  return cudaGetLastError();
}

}  // namespace

// in_kind: the canvas storage (smelter::CanvasKind). Returns the launch's cudaError_t.
extern "C" int smelter_yuv420_out(const void* rgba, void* y, void* u, void* v,
                                  int h, int w, int full_range, int in_kind,
                                  void* stream) {
  uint8_t* yp = static_cast<uint8_t*>(y);
  uint8_t* up = static_cast<uint8_t*>(u);
  uint8_t* vp = static_cast<uint8_t*>(v);
  const bool fr = full_range != 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_kind) {
    case kF32:
      return static_cast<int>(launch<kF32>(rgba, yp, up, vp, h, w, fr, st));
    case kU16:
      return static_cast<int>(launch<kU16>(rgba, yp, up, vp, h, w, fr, st));
    case kF16:
      return static_cast<int>(launch<kF16>(rgba, yp, up, vp, h, w, fr, st));
    case kBF16:
      return static_cast<int>(launch<kBF16>(rgba, yp, up, vp, h, w, fr, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
