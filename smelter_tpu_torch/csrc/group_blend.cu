// K4: one coalesced group of region-local layouts OVER-blended onto the
// canvas in one pass. Every pixel of the group's union (uy, ux, uh, uw)
// decodes its canvas value to f32 in registers, blends each member's layer
// in paint order, and is stored once, in place, in the canvas's storage
// (canvas_codec.cuh): one read and one write of the region.
//
// Stands for the XLA fusion of one group of smelter_tpu/ops/compose.py
// (_blend_group, :636: "one canvas region read, one fused elementwise chain,
// one slice write"); the JAX package has no Pallas kernel for it. Its plain
// version, the port's former torch chain, is in
// smelter_tpu_torch/ops/hopper/group_blend.py, and the operation order here
// is that version's, operation for operation (-fmad=false, no fast math):
// the SDF, smoothstep and mask math of sdf_common.cuh, whose formula order
// is the same, and the members' own steps below. An sdf member is K1's
// member (sdf_common.cuh's load_member and member_layer), so the two
// kernels share one definition of a colour or box-shadow layer.
//
// Member kinds (GroupMember.kind):
//   - kYuv: a static YUV tile from its three f32 GEMM products (luma and the
//     two chroma planes resized, on the u8 scale; rows at a stride): the
//     colour tail of color_convert.yuv_products_rgba_cm, then the texture
//     edge (rounded-rect SDF of the layout's rect), the border and the
//     masks, over the whole union; outside the tile the content is 0, as the
//     plain version's zero padding;
//   - kRgba: the same with a (4, h, w) f32 RGBA tile;
//   - kPlaced: a premultiplied (4, h, w) layer at a static origin (a stably
//     rotated tile), times the layout's masks where n_masks > 0, zero
//     outside;
//   - kSdf: a colour or box-shadow layout, evaluated at each union pixel
//     from its parameter row alone (no planes): its rounded-rect SDF,
//     rotation, border, blur and masks. Each block builds the member's
//     constants once in shared memory (load_member, as K1 does) and skips
//     the pixels outside the box set_region proves it cannot reach (its
//     layer is exactly 0 there, and OVER with 0 is the identity).
//
// Parameters: each member's descriptor (pointers, strides, static origin
// and size, flags) is passed by value in the launch's arguments
// (__grid_constant__): a CUDA graph records them at capture, so nothing is
// read from a table cached across calls. Its dynamic numbers (rect, radii,
// border, masks) are a row of the device tensor that
// scene_assembly.pack_member_params builds each frame (sdf_common.cuh's
// layout).
//
// Bound on the H100 by bytes: the union's canvas values read and written
// once (32 bytes a pixel in f32, 16 in 16 bits) and each member's inputs
// read once over its footprint (12 bytes a pixel for a YUV tile's three
// products, 16 for an RGBA tile or a placed layer, none for an sdf member
// but its parameter row). Design, simple first:
// one thread per union pixel, 32 threads of a warp along a row (128-byte
// lines per plane in f32), every member looped in registers from the
// argument space (uniform across the block, so its loads broadcast). The
// SDF work is a few dozen f32 operations a member a pixel, far under the
// card's f32 rate at these byte counts.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "canvas_codec.cuh"
#include "sdf_common.cuh"

namespace {

constexpr int kMaxMembers = 32;  // group_blend.MAX_MEMBERS
constexpr int kYuv = 0, kPlaced = 2, kSdf = 3;  // group_blend.KINDS; 1 is an RGBA tile
constexpr int kBlockX = 32, kBlockY = 8;

// Every constant is the Python double of color_convert rounded once to f32,
// as PyTorch rounds a Python scalar against an f32 tensor.
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
constexpr float kFootroom = static_cast<float>(16.0 / 255.0);
constexpr float kInvYScale = static_cast<float>(1.0 / (219.0 / 255.0));
constexpr float kInvUvScale = static_cast<float>(1.0 / (224.0 / 255.0));
constexpr float kRv = static_cast<float>(1.5748), kGu = static_cast<float>(0.1873),
                kGv = static_cast<float>(0.4681), kBu = static_cast<float>(1.8556);

// One member, as group_blend._Member packs it (104 bytes).
struct GroupMember {
  const float* plane[4];  // kYuv: Y, U, V products; kSdf: none; otherwise R, G, B, A
  int row_stride[4];      // elements between rows, per plane
  const float* params;    // the member's row of pack_member_params
  int kind, has_border, full_range, n_masks;
  int rotated_bits, top, left, h, w;  // static origin and size of the planes
  int sdf_kind, has_rotation;  // kSdf: smelter::kKindColor or kKindShadow, rotated
};
static_assert(sizeof(GroupMember) == 104, "group_blend._Member's layout");

struct GroupArgs {
  GroupMember m[kMaxMembers];
  int n;
  int has_sdf;  // some member is kSdf
};

// The BT.709 tail of yuv_products_rgba_cm for one pixel's products.
__device__ __forceinline__ void yuv_tail(float y, float u, float v,
                                         int full_range, float rgba[4]) {
  y = y * kInv255;
  u = u * kInv255;
  v = v * kInv255;
  if (!full_range) {
    y = (y - kFootroom) * kInvYScale;
    u = (u - kFootroom) * kInvUvScale;
    v = (v - kFootroom) * kInvUvScale;
  }
  u = u - 0.5f;
  v = v - 0.5f;
  rgba[0] = y + kRv * v;
  rgba[1] = y - kGu * u - kGv * v;
  rgba[2] = y + kBu * u;
  rgba[3] = 1.0f;
}

// The layer of a kYuv or kRgba member at canvas pixel (x, y): the
// non-rotated texture branch of group_blend.member_layer_plain.
__device__ __forceinline__ void tile_layer(const GroupMember& m, int x, int y,
                                           float px, float py, float layer[4]) {
  const float* p = m.params;
  const float rw = p[2], rh = p[3];
  const float cx = p[1] + rw * 0.5f;
  const float cy = p[0] + rh * 0.5f;
  const float dx = px - cx;
  const float dy = py - cy;
  const float ma =
      m.n_masks > 0 ? smelter::mask_alpha(p, px, py, m.n_masks, m.rotated_bits) : 1.0f;
  const float edge =
      -smelter::rounded_rect_sdf(dx, dy, rw * 0.5f, rh * 0.5f, p[5], p[6], p[7], p[8]);
  float content[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int ly = y - m.top, lx = x - m.left;
  if (ly >= 0 && ly < m.h && lx >= 0 && lx < m.w) {
    if (m.kind == kYuv) {
      const float yv = m.plane[0][static_cast<size_t>(ly) * m.row_stride[0] + lx];
      const float uv = m.plane[1][static_cast<size_t>(ly) * m.row_stride[1] + lx];
      const float vv = m.plane[2][static_cast<size_t>(ly) * m.row_stride[2] + lx];
      yuv_tail(yv, uv, vv, m.full_range, content);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        content[c] = m.plane[c][static_cast<size_t>(ly) * m.row_stride[c] + lx];
    }
  }
  if (m.has_border) {
    const float bw = p[13];
    const float bcol[4] = {p[14] * p[17], p[15] * p[17], p[16] * p[17], p[17]};
    const float border_alpha = smelter::smoothstep(bw - 0.5f, bw + 0.5f, edge);
    const float content_alpha = smelter::smoothstep(-0.5f, 0.5f, edge);
    const bool inner = edge > bw * 0.5f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      layer[c] = inner ? bcol[c] + (content[c] - bcol[c]) * border_alpha
                       : bcol[c] * content_alpha;
    if (m.n_masks > 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) layer[c] = layer[c] * ma;
    }
  } else {
    float a = smelter::smoothstep(-0.5f, 0.5f, edge);
    if (m.n_masks > 0) a = a * ma;
#pragma unroll
    for (int c = 0; c < 4; ++c) layer[c] = content[c] * a;
  }
}

// The layer of a kPlaced member at canvas pixel (x, y).
__device__ __forceinline__ void placed_layer(const GroupMember& m, int x, int y,
                                             float px, float py, float layer[4]) {
  const int ly = y - m.top, lx = x - m.left;
  if (ly < 0 || ly >= m.h || lx < 0 || lx >= m.w) {
#pragma unroll
    for (int c = 0; c < 4; ++c) layer[c] = 0.0f;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    layer[c] = m.plane[c][static_cast<size_t>(ly) * m.row_stride[c] + lx];
  if (m.n_masks > 0) {
    const float ma = smelter::mask_alpha(m.params, px, py, m.n_masks, m.rotated_bits);
#pragma unroll
    for (int c = 0; c < 4; ++c) layer[c] = layer[c] * ma;
  }
}

template <int kKind>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    group_blend_kernel(void* __restrict__ canvas, int h, int w, int uy, int ux,
                       int uh, int uw, const __grid_constant__ GroupArgs args) {
  // the constants of the sdf members, built once a block from their rows
  __shared__ smelter::MemberConst sdf[kMaxMembers];
  if (args.has_sdf) {  // uniform across the grid
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    if (tid < args.n && args.m[tid].kind == kSdf) {
      const GroupMember& m = args.m[tid];
      smelter::load_member(m.params, m.sdf_kind, m.has_border, m.has_rotation,
                           m.n_masks, m.rotated_bits, sdf[tid]);
      smelter::set_region(sdf[tid], uy, ux, uy + uh, ux + uw);
    }
    __syncthreads();
  }
  const int tx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ty = blockIdx.y * blockDim.y + threadIdx.y;
  if (tx >= uw || ty >= uh) return;
  const int x = ux + tx, y = uy + ty;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t i = static_cast<size_t>(y) * w + x;
  float acc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = smelter::load<kKind>(canvas, c * plane + i);
  for (int k = 0; k < args.n; ++k) {
    const GroupMember& m = args.m[k];
    float layer[4];
    if (m.kind == kSdf) {
      const smelter::MemberConst& s = sdf[k];
      if (y < s.ry0 || y >= s.ry1 || x < s.rx0 || x >= s.rx1) continue;
      smelter::member_layer(s, px, py, layer);
    } else if (m.kind == kPlaced) {
      placed_layer(m, x, y, px, py, layer);
    } else {
      tile_layer(m, x, y, px, py, layer);
    }
    smelter::over(layer, acc);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) smelter::store<kKind>(canvas, c * plane + i, acc[c]);
}

template <int kKind>
cudaError_t launch(void* canvas, int h, int w, int uy, int ux, int uh, int uw,
                   const GroupArgs& args, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((uw + kBlockX - 1) / kBlockX, (uh + kBlockY - 1) / kBlockY);
  group_blend_kernel<kKind><<<grid, block, 0, stream>>>(canvas, h, w, uy, ux, uh, uw, args);
  return cudaGetLastError();
}

}  // namespace

// canvas: (4, h, w) contiguous in storage `canvas_kind` (smelter::CanvasKind),
// updated in place over the union; members: a host array of n GroupMember
// (member_size bytes each, checked), copied into the launch's arguments.
// Returns the launch's cudaError_t.
extern "C" int smelter_group_blend(void* canvas, int canvas_kind, int h, int w,
                                   int uy, int ux, int uh, int uw,
                                   const void* members, int n, int member_size,
                                   void* stream) {
  if (member_size != static_cast<int>(sizeof(GroupMember)) || n < 0 ||
      n > kMaxMembers || h <= 0 || w <= 0 || uh <= 0 || uw <= 0 || uy < 0 ||
      ux < 0 || uy + uh > h || ux + uw > w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GroupArgs args;
  std::memset(&args, 0, sizeof(args));
  std::memcpy(args.m, members, sizeof(GroupMember) * n);
  args.n = n;
  for (int k = 0; k < n; ++k) args.has_sdf |= args.m[k].kind == kSdf;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (canvas_kind) {
    case smelter::kF32:
      return static_cast<int>(launch<smelter::kF32>(canvas, h, w, uy, ux, uh, uw, args, st));
    case smelter::kU16:
      return static_cast<int>(launch<smelter::kU16>(canvas, h, w, uy, ux, uh, uw, args, st));
    case smelter::kF16:
      return static_cast<int>(launch<smelter::kF16>(canvas, h, w, uy, ux, uh, uw, args, st));
    case smelter::kBF16:
      return static_cast<int>(launch<smelter::kBF16>(canvas, h, w, uy, ux, uh, uw, args, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
