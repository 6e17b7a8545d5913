// K1: single-pass SDF scene assembly. Creates the channel-major premultiplied
// (4, H, W) f32 canvas of a run of colour and box-shadow members: every
// pixel starts transparent black in registers, OVER-blends each member in
// paint order, and is written once.
//
// Replaces the Pallas TPU kernel smelter_tpu/ops/pallas/scene_assembly.py
// (_kernel_body, with _blend_member, _mask_alpha_rows, _sdf, _smoothstep).
// The layer math and the tile classes are in sdf_common.cuh.
//
// Bound on the H100 by one 4K f32 canvas write (4 x 3840 x 2160 x 4 bytes =
// 133 MB, 0.0396 ms at 3.35 TB/s); nothing is read but the small member
// tables. What the design does about it:
//   - Persistent blocks of 256 threads walk the canvas's 32 x 32 tiles;
//     each thread owns 4 consecutive x of one row: a float4 store per plane
//     where W % 4 == 0 and the canvas is 16-byte aligned (a scalar path
//     otherwise), so a warp writes four full 128-byte lines per plane.
//   - A block loads its members once (when there are at most kChunk; in
//     passes of kChunk per tile otherwise, so their number is unbounded):
//     what is constant per member (centre, half sizes, colours, cos and sin
//     of the rotation, the premises) goes to shared memory, from a row read
//     into registers in one go.
//   - Per tile, each warp classifies every member over its 4 rows on the
//     device, from this frame's parameters (sdf_common.cuh: warp_classes,
//     one member a lane, no block barrier): members classed outside are
//     dropped, interior members blend one flat value per pixel without the
//     SDF, and an opaque interior member that covers the rows starts them
//     over (the members under it are skipped). Only edge members run the
//     per-pixel SDF.
//   - The region (each member's clipped pixel footprint, from the host) is
//     part of the function: the plain version evaluates a member only
//     there, so the kernel checks it per pixel. The block clips it further
//     to the box the member can reach (sdf_common.cuh: set_region), where a
//     lane's region test rejects most tiles before any classification.
//
// Spec row (int32, kSpecW wide): kind, has_border, has_rotation, n_masks,
// rotated-mask bits, region y0, x0, y1, x1 (half-open, clipped to the
// canvas).

#include <cuda_runtime.h>

#include <cstdint>

#include "sdf_common.cuh"

namespace {

constexpr int kSpecW = 9;
constexpr int kTile = 32;
constexpr int kVec = 4;                       // pixels per thread, along x
constexpr int kThreadsX = kTile / kVec;       // 8
constexpr int kThreads = kThreadsX * kTile;   // 256
constexpr int kRowsPerWarp = 32 / kThreadsX;  // 4

__device__ __forceinline__ void load_spec_member(const int* __restrict__ specs,
                                                 const float* __restrict__ params,
                                                 int param_w, int li,
                                                 smelter::MemberConst& m) {
  int s[kSpecW];
#pragma unroll
  for (int i = 0; i < kSpecW; ++i) s[i] = specs[li * kSpecW + i];
  smelter::load_member(params + static_cast<size_t>(li) * param_w, s[0], s[1],
                       s[2], s[3], s[4], m);
  smelter::set_region(m, s[5], s[6], s[7], s[8]);
}

// (kThreads, 2): without a floor of 2 blocks per SM, ptxas holds the kernel
// to 64 registers and spills; with it, it takes 86 and spills nothing, and
// the store path runs at the card's fill rate (PERF.md, PR 3).
__global__ void __launch_bounds__(kThreads, 2)
    scene_assembly_kernel(const int* __restrict__ specs,
                          const float* __restrict__ params,
                          float* __restrict__ out, int n_members,
                          int param_w, int h, int w, int vec) {
  __shared__ smelter::MemberConst members[smelter::kChunk];

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int tiles_x = (w + kTile - 1) / kTile;
  const int n_tiles = tiles_x * ((h + kTile - 1) / kTile);
  const size_t plane = static_cast<size_t>(h) * w;
  const bool resident = n_members <= smelter::kChunk;
  if (resident && tid < n_members)
    load_spec_member(specs, params, param_w, tid, members[tid]);
  __syncthreads();

  // the block's tiles, blockIdx.x + k * gridDim.x, walked without a division
  const int step_x = gridDim.x % tiles_x, step_y = gridDim.x / tiles_x;
  int tile_x = static_cast<int>(blockIdx.x) % tiles_x - step_x;
  int tile_y = static_cast<int>(blockIdx.x) / tiles_x - step_y;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    tile_x += step_x;
    tile_y += step_y;
    if (tile_x >= tiles_x) {
      tile_x -= tiles_x;
      ++tile_y;
    }
    const int tx0 = tile_x * kTile, ty0 = tile_y * kTile;
    const int tx1 = min(tx0 + kTile, w);
    // the warp's strip: 4 rows of the tile
    const int sy0 = ty0 + (tid / 32) * kRowsPerWarp;
    const int sy1 = min(sy0 + kRowsPerWarp, h);
    const int x = tx0 + threadIdx.x * kVec;
    const int y = ty0 + threadIdx.y;
    const float py = static_cast<float>(y) + 0.5f;
    float acc[kVec][4];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[k][c] = 0.0f;
    bool bad = false;

    for (int base = 0; base < n_members; base += smelter::kChunk) {
      const int cnt = min(smelter::kChunk, n_members - base);
      if (!resident) {  // block-uniform
        __syncthreads();
        if (tid < cnt) load_spec_member(specs, params, param_w, base + tid, members[tid]);
        __syncthreads();
      }
      unsigned present, interior;
      if (smelter::warp_classes<true>(members, cnt, tx0, tx1, sy0, sy1, bad,
                                      present, interior)) {
#pragma unroll
        for (int k = 0; k < kVec; ++k)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[k][c] = 0.0f;
      }
      while (present) {
        const int li = __ffs(present) - 1;
        present &= present - 1u;
        const smelter::MemberConst& m = members[li];
        if (y < m.ry0 || y >= m.ry1) continue;
        const bool flat = (interior >> li) & 1u;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int xk = x + k;
          if (xk < m.rx0 || xk >= m.rx1) continue;
          float layer[4];
          if (flat) {
#pragma unroll
            for (int c = 0; c < 4; ++c) layer[c] = m.flat[c];
          } else {
            smelter::member_layer(m, static_cast<float>(xk) + 0.5f, py, layer);
          }
          smelter::over(layer, acc[k]);
        }
      }
    }

    if (y >= h || x >= w) continue;
    const size_t i = static_cast<size_t>(y) * w + x;
    if (vec) {  // W % 4 == 0, so all 4 pixels are in the row
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(out + c * plane + i) =
            make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (x + k < w)
#pragma unroll
          for (int c = 0; c < 4; ++c) out[c * plane + i + k] = acc[k][c];
    }
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
  const int vec = w % kVec == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int n_tiles = ((w + kTile - 1) / kTile) * ((h + kTile - 1) / kTile);
  const dim3 block(kThreadsX, kTile);
  const int grid =
      smelter::persistent_grid(scene_assembly_kernel, kThreads, n_tiles);
  scene_assembly_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(specs), static_cast<const float*>(params),
      static_cast<float*>(out), n_members, param_w, h, w, vec);
  return static_cast<int>(cudaGetLastError());
}
