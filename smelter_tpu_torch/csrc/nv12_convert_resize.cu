// NV12 tiles converted to RGBA and resized in one pass: the decoder's u8
// planes in, each tile's four channel-major f32 products out (the (4, h, w)
// tile kernel K4 reads as an "rgba" member).
//
// For each static NV12 texture the JAX package's general route converts the
// whole picture to f32 RGBA (smelter_tpu/ops/color_convert.py, nv12_to_rgba:
// the chroma upsampled 2x, the limited range expanded and clamped, BT.709,
// RGB clamped to [0, 1], alpha 1) and resizes the tile's crop of it by two
// matmuls (resample.resize_matmul), which XLA fuses into the frame program.
// There is no Pallas kernel for it: this kernel stands for that fusion. Its
// arithmetic, as the port's eager chain computes it on the card:
//   1. per full-resolution pixel of a strip's window (halo included): the
//      u8 samples times 1/255; the chroma's bilinear 2x upsample, rows
//      first, each output sample (1 - f) * texel i0 + f * texel i1 with
//      i0 = max((i - 1) >> 1, 0), i1 = min(i0 + 1, n - 1) and f 0.75 for an
//      even i, 0.25 for an odd one (color_convert._upsample_axis); the range
//      expansion (x - 16/255) times the f32 reciprocal of the scale, as
//      PyTorch divides a CUDA tensor by a scalar, clamped to [0, 1]; the
//      BT.709 matrix, clamped to [0, 1]; each channel rounded to bf16
//      (nearest even), as the GEMM's operand is; every operation rounded
//      on its own (built with -fmad=false);
//   2. the resize of the four channels by banded_resize.cuh's height and
//      width passes (f32 sums of bf16 weight x bf16 value on the tensor
//      cores), each pass's sum rounded to bf16, as resize_matmul rounds both
//      axes, and the result stored as f32. Alpha is the same resize of a
//      window of ones: the weights' sums, rounded as the GEMMs round them.
// An axis of unchanged size is one tap of weight 1 (grid_resize.axis_band),
// which leaves its values as they are, as resize_matmul skips it.
//
// Bound on the H100 by bytes: each input sample read once and each f32
// product written once (16 x 1080p NV12 into 16 tiles of 960x540: 49.8 MB
// in, 132.7 MB out, 0.054 ms at 3.35 TB/s). The chain it replaces wrote and
// re-read the full-resolution picture in f32 many times over (about 113
// eager kernels an input), built mip levels no static tile reads, and
// multiplied the transposed picture by dense weight matrices. Design:
// banded_resize.cuh's strips, one tile's four channels a strip. For each
// strip a block copies with cp.async, a strip ahead, the luma window and the
// interleaved chroma window under it (its halo: one chroma row and column
// either side), and the strip's weights; converts each window pixel once,
// into three bf16 channel windows in shared memory (zeros outside the
// window), four pixels a thread; then runs the four channels' height passes
// together (the weights' fragments loaded once for them; alpha's B
// fragments constant ones), then their width passes the same way, and
// stores each output pair into its channel plane. The full-resolution
// picture and the upsampled chroma never reach HBM.

#include "banded_resize.cuh"

namespace {

constexpr int kMaxTiles = kMaxPlanes / 4;  // tiles a launch takes: 4 channel planes each

// One tile of a launch: its whole luma plane and interleaved chroma plane,
// their bytes between rows, the crop's first luma row and column, the
// chroma plane's rows and columns, and the tile's (4, h, pitch) f32
// products, with floats between rows and between channel planes.
struct Nv12Tile {
  const uint8_t* y;
  const uint8_t* uv;
  float* dst;
  int y_stride, uv_stride, top, left, c_rows, c_cols, dst_stride, dst_plane;
};

// The conversion's f32 constants, as the port's eager chain uses them
// (nv12_resize.constants): 1/255, 16/255, the reciprocals of the luma and
// chroma scales, and the BT.709 coefficients.
struct Conv {
  float inv255, foot, inv_y_scale, inv_uv_scale, r_v, g_u, g_v, b_u;
};

struct Nv12Args {
  Nv12Tile t[kMaxTiles];
  Conv k;
  StripArgs s;
};

// x clamped to [0, 1] in one instruction (a saturating operation; for an
// input with no NaN the same value as torch.clamp's, +0 for -0)
__device__ __forceinline__ float clamp01(float x) { return __saturatef(x); }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [0, rows) of `bytes` bytes from `from` (rows `stride` bytes apart)
// into `to` (rows `pitch` bytes apart), 16 bytes an item, zeros past
// `bytes` in the last: with cp.async where `aligned` (both 16-byte aligned),
// else byte by byte.
__device__ void copy_rows(uint8_t* to, int pitch, const uint8_t* from, long long stride, int rows,
                          int bytes, bool aligned) {
  const int chunks = (bytes + 15) >> 4;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int s = i / chunks, x = (i - s * chunks) << 4;
    const int n = min(bytes - x, 16);
    const uint8_t* p = from + s * stride + x;
    if (aligned) {
      copy16(to + s * pitch + x, p, n);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (b < n) w[b >> 2] |= static_cast<uint32_t>(__ldg(p + b)) << (8 * (b & 3));
      }
      *reinterpret_cast<uint4*>(to + s * pitch + x) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Where strip `d`'s windows lie: its first luma row and column in the
// picture, and the first chroma row and the first byte of the chroma rows
// (a multiple of 16) its halo needs, with their count and bytes.
struct Window {
  int r0, x0, c0, c_n, b0, b_n;
  __device__ Window(const Nv12Tile& t, const int* d) {
    r0 = t.top + d[kSr0];
    x0 = t.left + d[kXw0];
    c0 = max((r0 - 1) >> 1, 0);
    c_n = min(max((r0 + d[kHwin] - 2) >> 1, 0) + 1, t.c_rows - 1) - c0 + 1;
    b0 = (2 * max((x0 - 1) >> 1, 0)) & ~15;
    b_n = 2 * min(max((x0 + d[kWwin] - 2) >> 1, 0) + 1, t.c_cols - 1) + 2 - b0;
  }
};

// Start the copies of strip `d`'s luma window into `y` (rows of wpad
// bytes), its chroma window into `uv` (rows of wpad + 32 bytes), its row and
// column blocks' weights into `hw` and `ww`, and of the strip row `next` (or
// none) into `next_desc`.
__device__ void start_strip(const Nv12Args& a, const int* d, uint8_t* y, uint8_t* uv, int* hw,
                            int* ww, const int* next, int* next_desc) {
  const Nv12Tile& t = a.t[d[kSrc] - a.s.first];
  const Window w(t, d);
  const uint8_t* y_at = t.y + static_cast<long long>(w.r0) * t.y_stride + w.x0;
  const uint8_t* uv_at = t.uv + static_cast<long long>(w.c0) * t.uv_stride + w.b0;
  copy_rows(y, d[kWpad], y_at, t.y_stride, d[kHwin], d[kWwin],
            ((reinterpret_cast<uintptr_t>(y_at) | static_cast<uintptr_t>(t.y_stride)) & 15) == 0);
  copy_rows(uv, d[kWpad] + 32, uv_at, t.uv_stride, w.c_n, w.b_n,
            ((reinterpret_cast<uintptr_t>(uv_at) | static_cast<uintptr_t>(t.uv_stride)) & 15) == 0);
  const int h_quads = h_entry_ints((d[kRn] + 15) >> 4, d[kKh]) >> 2;
  const int w_quads = w_entry_ints((d[kCn] + 7) >> 3, d[kKw]) >> 2;
  for (int i = threadIdx.x; i < h_quads + w_quads; i += kThreads) {
    if (i < h_quads) {
      copy16(hw + 4 * i, a.s.table + d[kHrow] + 4 * i, 16);
    } else {
      copy16(ww + 4 * (i - h_quads), a.s.table + d[kWcol] + 4 * (i - h_quads), 16);
    }
  }
  if (next != nullptr && threadIdx.x < kStripInts / 4) {
    copy16(next_desc + 4 * threadIdx.x, next + 4 * threadIdx.x, 16);
  }
  copies_commit();
}

// A chroma sample (byte `p` of its pair: 0 U, 1 V) at chroma byte offset
// `o` upsampled along the rows to a luma row whose chroma rows are `row0`
// and `row1`, with weights f0 and f1.
__device__ __forceinline__ float row_upsampled(const Conv& k, const uint8_t* row0,
                                               const uint8_t* row1, int o, float f0, float f1) {
  return static_cast<float>(row0[o]) * k.inv255 * f0 + static_cast<float>(row1[o]) * k.inv255 * f1;
}

// A pixel's R, G and B from its luma sample and its upsampled chroma.
__device__ __forceinline__ void rgb_of(const Conv& k, uint8_t y, float uf, float vf, float* rgb) {
  const float yl = clamp01((static_cast<float>(y) * k.inv255 - k.foot) * k.inv_y_scale);
  const float u = clamp01((uf - k.foot) * k.inv_uv_scale) - 0.5f;
  const float v = clamp01((vf - k.foot) * k.inv_uv_scale) - 0.5f;
  rgb[0] = clamp01(yl + k.r_v * v);
  rgb[1] = clamp01(yl - k.g_u * u - k.g_v * v);
  rgb[2] = clamp01(yl + k.b_u * u);
}

// Strip `d`'s window converted: each pixel's R, G and B rounded to bf16
// into S, S + plane and S + 2 * plane (rows of `spitch`), zeros outside the
// window, from the luma window `y` and the chroma window `uv`. A thread
// converts four neighbouring pixels of a column of rows. Their chroma
// columns lie among four: base = max((col - 1) >> 1, 0) and the three after
// it (clamped to the plane), each upsampled along the rows once a row; each
// pixel reads the column of its own offset from base and the one after it:
// offsets 0 1 1 2 from an even first column, 0 0 1 1 from an odd one and
// 0 0 0 1 from column 0. What depends on the columns alone is worked out
// once.
__device__ void convert_window(const Nv12Args& a, const int* d, const uint8_t* y,
                               const uint8_t* uv, uint16_t* S, int plane, int spitch) {
  const Nv12Tile& t = a.t[d[kSrc] - a.s.first];
  const Conv& k = a.k;
  const Window w(t, d);
  const int hwin = d[kHwin], hpad = d[kHpad], wwin = d[kWwin], wpad = d[kWpad];
  const int quads = wpad >> 2, uv_pitch = wpad + 32, last = t.c_cols - 1;
  // threads in rows of `across` quads, `down` rows at a time
  const int across = min(quads, kThreads), down = kThreads / across;
  if (threadIdx.x >= across * down) return;
  for (int p = threadIdx.x % across; p < quads; p += across) {
    const int x = 4 * p, col = w.x0 + x, base = max((col - 1) >> 1, 0);
    int o[4];  // the byte offsets of chroma columns base .. base + 3
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = 2 * min(base + i, last) - w.b0;
    const int shape = (col & 1) ? 1 : (col == 0 ? 2 : 0);
    // the weight of a pixel's second chroma column: 0.75 at an even column
    const float g1e = (col & 1) ? 0.25f : 0.75f, g1o = (col & 1) ? 0.75f : 0.25f;
    const float g0e = 1.0f - g1e, g0o = 1.0f - g1o;
    const int n = x < wwin ? min(wwin - x, 4) : 0;  // window pixels of the quad
    for (int r = threadIdx.x / across; r < hpad; r += down) {
      float rgb[4][3] = {};
      if (r < hwin && n > 0) {
        const int j = w.r0 + r;
        const int i0 = max((j - 1) >> 1, 0), i1 = min(i0 + 1, t.c_rows - 1);
        const float f1 = (j & 1) ? 0.25f : 0.75f, f0 = 1.0f - f1;
        const uint8_t* row0 = uv + (i0 - w.c0) * uv_pitch;
        const uint8_t* row1 = uv + (i1 - w.c0) * uv_pitch;
        float ru[4], rv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ru[i] = row_upsampled(k, row0, row1, o[i], f0, f1);
          rv[i] = row_upsampled(k, row0, row1, o[i] + 1, f0, f1);
        }
        const uint32_t y4 = *reinterpret_cast<const uint32_t*>(y + r * wpad + x);
        // pixel e from chroma columns base + i and base + i + 1
        auto pixel = [&](int e, int i) {
          const float g0 = (e & 1) ? g0o : g0e, g1 = (e & 1) ? g1o : g1e;
          if (e < n) {
            rgb_of(k, static_cast<uint8_t>(y4 >> (8 * e)), ru[i] * g0 + ru[i + 1] * g1,
                   rv[i] * g0 + rv[i + 1] * g1, rgb[e]);
          }
        };
        if (shape == 0) {
          pixel(0, 0), pixel(1, 1), pixel(2, 1), pixel(3, 2);
        } else if (shape == 1) {
          pixel(0, 0), pixel(1, 0), pixel(2, 1), pixel(3, 1);
        } else {
          pixel(0, 0), pixel(1, 0), pixel(2, 0), pixel(3, 1);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        *reinterpret_cast<uint2*>(S + c * plane + r * spitch + x) =
            make_uint2(pack_bf16(rgb[0][c], rgb[1][c]), pack_bf16(rgb[2][c], rgb[3][c]));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) nv12_convert_resize_kernel(const Nv12Args args) {
  extern __shared__ __align__(16) uint8_t smem[];
  const StripArgs& sa = args.s;
  // shared memory: two sets of buffers (one being copied while the other is
  // used) of a luma window, its chroma window and its row and column
  // blocks' weights; the three bf16 channel windows (S); the four channels'
  // bf16 height passes (T); three strip rows (nv12_resize.smem_bytes). Rows
  // of S and T are an odd number of 16 bytes apart.
  const int spitch_max = sa.wpad + 8;
  const int y_bytes = sa.hpad * sa.wpad, uv_bytes = (sa.hpad / 2 + 2) * (sa.wpad + 32);
  const int set_bytes = y_bytes + uv_bytes + 4 * (sa.h_ints + sa.w_ints);
  const int plane = sa.hpad * spitch_max, t_plane = sa.mrows * spitch_max;
  uint16_t* S = reinterpret_cast<uint16_t*>(smem + 2 * set_bytes);
  uint16_t* T = S + 3 * plane;
  int* desc = reinterpret_cast<int*>(T + 4 * t_plane);  // 3 x kStripInts

  const Lanes l;
  const int step = gridDim.x;
  const int* strips = sa.table + static_cast<long long>(sa.strips) * kStripInts;
  auto parts = [&](int i, uint8_t*& y, uint8_t*& uv, int*& hw, int*& ww) {
    uint8_t* set = smem + (i & 1) * set_bytes;
    y = set;
    uv = set + y_bytes;
    hw = reinterpret_cast<int*>(set + y_bytes + uv_bytes);
    ww = hw + sa.h_ints;
  };

  int s = blockIdx.x;
  if (threadIdx.x < kStripInts) desc[threadIdx.x] = __ldg(strips + s * kStripInts + threadIdx.x);
  __syncthreads();
  {
    uint8_t *y, *uv;
    int *hw, *ww;
    parts(0, y, uv, hw, ww);
    start_strip(args, desc, y, uv, hw, ww,
                s + step < sa.n_strips ? strips + (s + step) * kStripInts : nullptr,
                desc + kStripInts);
  }
  for (int i = 0; s < sa.n_strips; ++i, s += step) {
    const int* d = desc + (i % 3) * kStripInts;
    uint8_t *y, *uv;
    int *hw, *ww;
    parts(i, y, uv, hw, ww);
    copies_wait();
    __syncthreads();
    if (s + step < sa.n_strips) {
      uint8_t *ny, *nuv;
      int *nhw, *nww;
      parts(i + 1, ny, nuv, nhw, nww);
      start_strip(args, desc + ((i + 1) % 3) * kStripInts, ny, nuv, nhw, nww,
                  s + 2 * step < sa.n_strips ? strips + (s + 2 * step) * kStripInts : nullptr,
                  desc + ((i + 2) % 3) * kStripInts);
    }
    const int spitch = d[kWpad] + 8;
    convert_window(args, d, y, uv, S, plane, spitch);
    __syncthreads();

    // the four channels' height passes (alpha's of a window of ones), then
    // their width passes, each output pair stored into its channel plane
    height_pass<4, true>(l, d, hw, S, plane, T, t_plane, spitch);
    __syncthreads();
    const Nv12Tile& t = args.t[d[kSrc] - sa.first];
    const int cn = d[kCn], dstride = t.dst_stride;
    float* dst = t.dst + static_cast<long long>(d[kDstY]) * dstride + d[kDstX];
    width_pass<4>(l, d, ww, T, t_plane, spitch, [&](int c, int r, int cc, float lo, float hi) {
      store_pair(dst + c * static_cast<long long>(t.dst_plane) + r * dstride + cc, bf16_round(lo),
                 bf16_round(hi), cc, cn);
    });
    __syncthreads();  // S, T, this strip's buffers and row are free again
  }
}

}  // namespace

// ptrs: 3n host pointers, each tile's luma plane, interleaved chroma plane
// and f32 products; ints: 8n ints, each tile's bytes between luma rows and
// between chroma rows, the crop's first row and column, the chroma plane's
// rows and columns, and floats between product rows and between channel
// planes; conv: the 8 f32 constants of `Conv`; table: the device table;
// first: the table's plane of the launch's first tile; strips, n_strips:
// the table's row of its first strip and their number; hpad, wpad, mrows,
// h_ints, w_ints: its largest strip (shared memory layout, `smem_bytes` in
// all); blocks: the persistent blocks to launch (at most
// smelter_nv12_convert_resize_blocks_per_sm a card's SM, and one a strip).
// Returns the launch's cudaError_t.
extern "C" int smelter_nv12_convert_resize(void* const* ptrs, const int* ints, int n,
                                           const float* conv, const void* table, int first,
                                           int strips, int n_strips, int hpad, int wpad,
                                           int mrows, int h_ints, int w_ints, int smem_bytes,
                                           int blocks, void* stream) {
  if (n > kMaxTiles || !strip_args_valid(n, n_strips, strips, first, hpad, wpad, mrows, h_ints,
                                         w_ints, smem_bytes, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Nv12Args args;
  std::memset(&args, 0, sizeof(args));
  for (int i = 0; i < n; ++i) {
    const int* v = ints + 8 * i;
    args.t[i] = Nv12Tile{static_cast<const uint8_t*>(ptrs[3 * i]),
                         static_cast<const uint8_t*>(ptrs[3 * i + 1]),
                         static_cast<float*>(ptrs[3 * i + 2]),
                         v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
  }
  args.k = Conv{conv[0], conv[1], conv[2], conv[3], conv[4], conv[5], conv[6], conv[7]};
  args.s = StripArgs{static_cast<const int*>(table), strips, n_strips, first,
                     hpad, wpad, mrows, h_ints, w_ints};
  nv12_convert_resize_kernel<<<blocks, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of nv12_convert_resize_kernel an SM of the current card holds
// at `smem_bytes` of dynamic shared memory, or -1 (banded_resize.cuh's
// blocks_per_sm). Call it on each card before its first launch, outside a
// CUDA graph's capture.
extern "C" int smelter_nv12_convert_resize_blocks_per_sm(int smem_bytes) {
  return blocks_per_sm(nv12_convert_resize_kernel, smem_bytes);
}
