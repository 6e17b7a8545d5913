// K3: fused SDF layers. OVER-blends a run of L colour, bordered-colour and
// box-shadow layers onto an existing channel-major premultiplied (4, H, W)
// f32 canvas, in place.
//
// Replaces the Pallas TPU kernel smelter_tpu/ops/pallas/sdf_layers.py
// (_layer_kernel_body, launched by _compose_call). The layer math is in
// sdf_common.cuh (member_layer with no masks), which is the reference body
// operation for operation.
//
// Bound on the H100 by memory: the pixels the layers reach are read once
// and written once (at 4K, the renderer's highlight frame and banner reach
// about 14% of the 133 MB canvas). What the design does about it:
//   - Persistent blocks of 256 threads walk the canvas's 32 x 32 tiles. A
//     block loads its layers once (in passes of kChunk per tile when there
//     are more): the per-layer constants (centre, half sizes, colours, cos
//     and sin, the premises) go to shared memory, from a row read into
//     registers in one go.
//   - Per tile, each warp classifies every layer over its 4 rows, from this
//     frame's parameters (sdf_common.cuh: warp_classes, one layer a lane,
//     no block barrier); a lane first tests the box the layer can reach
//     (set_region), which rejects most tiles without classifying. Rows that
//     every layer misses are neither read nor written: the canvas is
//     updated in place, so only the rows the layers reach pay for memory.
//     There, interior layers blend one flat value per pixel without the
//     SDF; only edge layers run the per-pixel math.
//   - Each thread owns 4 consecutive x of one row: float4 loads and stores
//     per plane where W % 4 == 0 and the canvas is 16-byte aligned (a scalar
//     path otherwise); each pixel is read and written by the same thread.
//
// Parameter row (f32, kParamsBase = 19 wide, the order of the reference's
// pack_layer_params_traced): 0 top, 1 left, 2 width, 3 height, 4 rotation
// (degrees), 5..8 radius [tl, tr, br, bl], 9..12 colour (straight RGBA),
// 13 border width, 14..17 border colour, 18 blur radius.
// Kind row (int32, kKindW wide): content (0 colour, 1 box shadow),
// has_border, has_rotation.

#include <cuda_runtime.h>

#include <cstdint>

#include "sdf_common.cuh"

namespace {

constexpr int kKindW = 3;
constexpr int kTile = 32;
constexpr int kVec = 4;                       // pixels per thread, along x
constexpr int kThreadsX = kTile / kVec;       // 8
constexpr int kThreads = kThreadsX * kTile;   // 256
constexpr int kRowsPerWarp = 32 / kThreadsX;  // 4

__device__ __forceinline__ void load_layer(const float* __restrict__ params,
                                           const int* __restrict__ kinds, int li,
                                           int h, int w, smelter::MemberConst& m) {
  int k[kKindW];
#pragma unroll
  for (int i = 0; i < kKindW; ++i) k[i] = kinds[li * kKindW + i];
  smelter::load_member(params + static_cast<size_t>(li) * smelter::kParamsBase,
                       k[0], k[1], k[2], /*n_masks=*/0, 0, m);
  smelter::set_region(m, 0, 0, h, w);  // the canvas, clipped to the layer's reach
}

__global__ void __launch_bounds__(kThreads)
    sdf_layers_kernel(float* __restrict__ canvas,
                      const float* __restrict__ params,
                      const int* __restrict__ kinds, int n_layers, int h,
                      int w, int vec) {
  __shared__ smelter::MemberConst layers[smelter::kChunk];

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int tiles_x = (w + kTile - 1) / kTile;
  const int n_tiles = tiles_x * ((h + kTile - 1) / kTile);
  const size_t plane = static_cast<size_t>(h) * w;
  const bool resident = n_layers <= smelter::kChunk;
  if (resident && tid < n_layers) load_layer(params, kinds, tid, h, w, layers[tid]);
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
    const bool mine = y < h && x < w;
    const size_t i = static_cast<size_t>(y) * w + x;
    const float py = static_cast<float>(y) + 0.5f;
    float acc[kVec][4];
    bool loaded = false;  // warp-uniform: the rows are read at their first layer
    bool bad = false;

    for (int base = 0; base < n_layers; base += smelter::kChunk) {
      const int cnt = min(smelter::kChunk, n_layers - base);
      if (!resident) {  // block-uniform
        __syncthreads();
        if (tid < cnt) load_layer(params, kinds, base + tid, h, w, layers[tid]);
        __syncthreads();
      }
      unsigned present, interior;
      smelter::warp_classes<false>(layers, cnt, tx0, tx1, sy0, sy1, bad, present,
                                   interior);
      if (present && !loaded) {
        loaded = true;
        if (mine && vec) {  // W % 4 == 0, so all 4 pixels are in the row
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 v = *reinterpret_cast<const float4*>(canvas + c * plane + i);
            acc[0][c] = v.x;
            acc[1][c] = v.y;
            acc[2][c] = v.z;
            acc[3][c] = v.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[k][c] = mine && x + k < w ? canvas[c * plane + i + k] : 0.0f;
        }
      }
      while (present) {
        const int li = __ffs(present) - 1;
        present &= present - 1u;
        const smelter::MemberConst& m = layers[li];
        if ((interior >> li) & 1u) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) smelter::over(m.flat, acc[k]);
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            float layer[4];
            smelter::member_layer(m, static_cast<float>(x + k) + 0.5f, py, layer);
            smelter::over(layer, acc[k]);
          }
        }
      }
    }

    if (!loaded || !mine) continue;  // rows no layer reaches stay untouched
    if (vec) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(canvas + c * plane + i) =
            make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (x + k < w)
#pragma unroll
          for (int c = 0; c < 4; ++c) canvas[c * plane + i + k] = acc[k][c];
    }
  }
}

}  // namespace

extern "C" int smelter_sdf_layers(void* canvas, const void* params,
                                  const void* kinds, int n_layers, int h,
                                  int w, void* stream) {
  if (n_layers < 0 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = w % kVec == 0 && reinterpret_cast<uintptr_t>(canvas) % 16 == 0;
  const int n_tiles = ((w + kTile - 1) / kTile) * ((h + kTile - 1) / kTile);
  const dim3 block(kThreadsX, kTile);
  const int grid =
      smelter::persistent_grid(sdf_layers_kernel, kThreads, n_tiles);
  sdf_layers_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(canvas), static_cast<const float*>(params),
      static_cast<const int*>(kinds), n_layers, h, w, vec);
  return static_cast<int>(cudaGetLastError());
}
