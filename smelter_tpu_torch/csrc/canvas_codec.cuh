// The storage of the root planar canvas (smelter_tpu_torch/ops/compose.py
// _canvas_dtype): f32, or 16 bits (u16 fixed point, f16, bf16). Shared by
// K1 scene_assembly (its one store), K2 yuv_out (its loads) and K4
// group_blend (a region's load and store). The codes are those the entries
// take (scene_assembly.OUT_DTYPES, yuv_out.IN_DTYPES, group_blend's).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstddef>
#include <cstdint>

namespace smelter {

enum CanvasKind { kF32 = 0, kU16 = 1, kF16 = 2, kBF16 = 3 };
// the u16 fixed point of color_convert.canvas_decode: value * 8192 + 16384,
// decoded exactly in f32
constexpr float kFixedScale = 8192.0f;
constexpr float kFixedOffset = 16384.0f;
constexpr float kFixedStep = 1.0f / 8192.0f;

template <int kKind>
struct Storage {
  using T = uint16_t;  // the bits of a 16-bit value
};
template <>
struct Storage<kF32> {
  using T = float;
};

// One stored value as f32, as canvas_decode gives it.
template <int kKind>
__device__ __forceinline__ float decode(typename Storage<kKind>::T v);

template <>
__device__ __forceinline__ float decode<kF32>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float decode<kU16>(uint16_t v) {
  return (static_cast<float>(v) - kFixedOffset) * kFixedStep;
}

template <>
__device__ __forceinline__ float decode<kF16>(uint16_t v) {
  return __half2float(__ushort_as_half(v));
}

template <>
__device__ __forceinline__ float decode<kBF16>(uint16_t v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// One f32 value as the bits of its 16-bit storage (compose._canvas_encode).
template <int kKind>
__device__ __forceinline__ uint16_t encode16(float x);

template <>
__device__ __forceinline__ uint16_t encode16<kU16>(float x) {
  // one cvt.rni.u16.f32: round half to even (as torch.round), clamp to
  // [0, 65535] and NaN to code 0 (PTX's float-to-integer conversion
  // saturates and turns NaN into 0), as _canvas_encode pins it; a C++ cast
  // of NaN or of an out-of-range value would be undefined. The product by
  // 2^13 is exact, so contraction could not change the sum.
  const float v = x * kFixedScale + kFixedOffset;
  unsigned short q;
  asm("cvt.rni.u16.f32 %0, %1;" : "=h"(q) : "f"(v));
  return q;
}

template <>
__device__ __forceinline__ uint16_t encode16<kF16>(float x) {
  return __half_as_ushort(__float2half_rn(x));  // nearest even, as torch
}

template <>
__device__ __forceinline__ uint16_t encode16<kBF16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));  // nearest even, as torch
}

// One f32 value stored in the canvas's storage (f32 as it is).
template <int kKind>
__device__ __forceinline__ void store(void* canvas, size_t i, float x) {
  if constexpr (kKind == kF32) {
    static_cast<float*>(canvas)[i] = x;
  } else {
    static_cast<uint16_t*>(canvas)[i] = encode16<kKind>(x);
  }
}

// One value of the canvas, decoded.
template <int kKind>
__device__ __forceinline__ float load(const void* canvas, size_t i) {
  return decode<kKind>(static_cast<const typename Storage<kKind>::T*>(canvas)[i]);
}

}  // namespace smelter
