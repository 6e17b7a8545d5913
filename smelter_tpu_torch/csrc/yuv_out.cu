// K2: channel-major premultiplied RGBA f32 canvas -> BT.709 YUV420 u8 planes,
// in one pass.
//
// Replaces the Pallas TPU kernel smelter_tpu/ops/pallas/yuv_out.py
// (_kernel_body, with _pair_pool and _u8). Math order mirrors
// smelter_tpu_torch/ops/color_convert.py: rgb_planes_to_yuv, then the
// per-pixel clip to [0, 1], then the 2x2 chroma mean summed in window order
// ((a00 + a01) + a10) + a11 and scaled by 0.25, then round half to even
// (rintf) and clip to [0, 255].
//
// Bound on the H100 by memory bandwidth: it reads 3 of the canvas's 4 f32
// planes (alpha is never read; 12 bytes a pixel) and writes 1.5 bytes a
// pixel. Its design follows from that: one thread per 2x2 quad reads the
// quad's 12 values once, writes the 4 Y values and one U and one V value,
// and neighbouring threads touch neighbouring addresses. The full-resolution
// U and V planes that the unfused chain writes and reads back never exist.
//
// Any H and W are taken. Odd edges follow the VALID semantics of the
// reference chain: Y is full size, chroma is (H/2, W/2) rounded down, so a
// last odd row or column feeds Y only.

#include <cstdint>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ uint8_t to_u8(float x) {
  // rintf rounds half to even, as torch.round and jnp.round do
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

__global__ void yuv420_out_kernel(const float* __restrict__ rgba,
                                  uint8_t* __restrict__ y_out,
                                  uint8_t* __restrict__ u_out,
                                  uint8_t* __restrict__ v_out, int h, int w,
                                  bool full_range) {
  const int qx = blockIdx.x * blockDim.x + threadIdx.x;
  const int qy = blockIdx.y * blockDim.y + threadIdx.y;
  const int x0 = 2 * qx, y0 = 2 * qy;
  if (x0 >= w || y0 >= h) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* r_pl = rgba;
  const float* g_pl = rgba + plane;
  const float* b_pl = rgba + 2 * plane;

  float us[2][2], vs[2][2];
  for (int dy = 0; dy < 2; ++dy) {
    for (int dx = 0; dx < 2; ++dx) {
      const int yy = y0 + dy, xx = x0 + dx;
      if (yy >= h || xx >= w) continue;
      const size_t i = static_cast<size_t>(yy) * w + xx;
      const Yuv p = pixel_yuv(r_pl[i], g_pl[i], b_pl[i], full_range);
      y_out[i] = to_u8(p.y);
      us[dy][dx] = p.u;
      vs[dy][dx] = p.v;
    }
  }
  const int cw = w / 2;
  if (qx < cw && qy < h / 2) {
    const size_t c = static_cast<size_t>(qy) * cw + qx;
    float su = us[0][0] + us[0][1];
    su = su + us[1][0];
    su = su + us[1][1];
    float sv = vs[0][0] + vs[0][1];
    sv = sv + vs[1][0];
    sv = sv + vs[1][1];
    u_out[c] = to_u8(su * 0.25f);
    v_out[c] = to_u8(sv * 0.25f);
  }
}

}  // namespace

extern "C" int smelter_yuv420_out(const void* rgba, void* y, void* u, void* v,
                                  int h, int w, int full_range,
                                  void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 2 * 32 - 1) / (2 * 32), (h + 2 * 8 - 1) / (2 * 8));
  yuv420_out_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgba), static_cast<uint8_t*>(y),
      static_cast<uint8_t*>(u), static_cast<uint8_t*>(v), h, w,
      full_range != 0);
  return static_cast<int>(cudaGetLastError());
}
