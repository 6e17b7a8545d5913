// The banded Lanczos-3 resize shared by grid_resize.cu (u8 tiles written in
// place in the output planes of an opaque grid) and tile_resize.cu (the f32
// products of a tile convert, which kernel K4 reads). Both resize tile
// planes of u8 samples by a height pass and a width pass, each an f32 sum of
// bf16 weight x bf16 value on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate), the height pass rounded to bf16 (nearest even). They
// differ only in what the width pass's sum becomes (`store_pair`): a u8
// sample rounded through bf16, or the f32 sum as it is.
//
// The weights are bf16 matrices stored per output row as a band: the first
// source index, then the row's weights from there, padded with exact zeros
// to the widest row of the axis (grid_resize.matrix_band). The products are
// those of a dense GEMM on the same bf16 operands; only products by an
// exact zero are skipped.
//
// Design: the work is cut into strips, each up to 32 output rows x 128
// output columns of one tile plane (the wrapper picks the size per plane so
// that three, else two, blocks share an SM). The blocks are persistent and
// walk interleaved strips. For each strip a block copies with cp.async, into
// one of two buffer sets (the next strip's while it computes the current
// one), the u8 source window, halo included, and the weights of the strip's
// rows and columns: per m-tile of 16 rows and per n-tile of 8 columns, a
// dense bf16 block over only the k-tiles of 16 window samples its bands
// reach, laid out on the host. It widens the window to bf16, runs the height
// pass as tensor-core products (ldmatrix fragments) into a bf16 intermediate
// that takes the u8 window's place, then the width pass, and stores each
// output pair straight into its plane; halo re-reads come from L2. The
// static descriptors of every strip (source and output places, window,
// where its weights lie) and the weights are one int32 table on the device,
// uploaded once per program; the pointers of a launch go by value, so a
// CUDA graph records the frame's planes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 128;  // grid_resize.MAX_PLANES
constexpr int kStripInts = 16;   // grid_resize.STRIP_INTS
constexpr int kMaxUnits = 3;     // height-pass units (an m-tile's pair of n-tiles) a warp runs at once
constexpr int kMaxMTiles = 2;    // m-tiles of 16 rows a strip has (grid_resize.BLOCK_SHAPES)
constexpr int kMaxSmem = 227 * 1024;

// One strip's row of the table (grid_resize.plan_planes): the tile plane
// (its index among the table's planes), the output plane (grid: 0 Y, 1 U,
// 2 V; tile: the tile plane again) and the strip's first output row and
// column there, its rows and columns, its source window (first row, rows,
// first column (a multiple of 16), columns) and the window's padded rows and
// columns, the k-tiles of 16 its m-tiles' and n-tiles' weights span, and
// where its row block's and its column block's weights start in the table.
enum Strip {
  kSrc, kDst, kDstY, kDstX, kRn, kCn, kSr0, kHwin, kXw0, kWwin, kHpad, kWpad, kKh, kKw,
  kHrow, kWcol
};

// A row block's weights in the table: kHHead ints (for each of up to two
// m-tiles, the first k-tile of the window its weights start at, then for
// each the k-tiles they span), then each m-tile's 16 rows of 16 * kh + 8
// bf16, its weights over kh k-tiles from there (0 past its span and outside
// its bands). A column block's: kWHead ints (the same for up to sixteen
// n-tiles), then each n-tile's 8 rows of 16 * kw + 8 bf16 the same way. The
// 8 bf16 of padding keep ldmatrix's rows in distinct banks.
constexpr int kHHead = 4;
constexpr int kWHead = 32;

__device__ __forceinline__ int h_entry_ints(int mtiles, int kh) { return kHHead + mtiles * 8 * (16 * kh + 8); }
__device__ __forceinline__ int w_entry_ints(int ntiles, int kw) { return kWHead + ntiles * 4 * (16 * kw + 8); }

// What a launch of either kernel is given besides its planes.
struct StripArgs {
  const int* table;                // weights, then strips
  int strips;                      // the table's row of this launch's first strip
  int n_strips;
  int first;                       // the table's plane of src[0]
  // the launch's largest padded window rows and columns, strip rows (padded
  // to 16) and weight entries: the shared memory's layout
  int hpad, wpad, mrows, h_ints, w_ints;
};

__device__ __forceinline__ int round_up16(int x) { return (x + 15) & ~15; }

// Bytes i and i + 1 of `word` (u8 samples) as two bf16 in one register, the
// first in the low half. A u8 is exact in bf16: 0x4B0000vv is 2^23 + v in
// f32, so subtracting 2^23 gives v exactly, whose upper half is its bf16.
__device__ __forceinline__ uint32_t bf16x2_of_bytes(uint32_t word, int i) {
  const float lo = __uint_as_float(__byte_perm(word, 0x4B00u, 0x5440 | i)) - 8388608.0f;
  const float hi = __uint_as_float(__byte_perm(word, 0x4B00u, 0x5440 | (i + 1))) - 8388608.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices of bf16 from shared memory, lane l giving the address
// of row l & 7 of matrix l >> 3: as they are (an A fragment of rows 0-7 and
// 8-15 and columns 0-7 and 8-15) or transposed (B fragments of a row-major
// k x n block).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const uint16_t* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const uint16_t* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const uint16_t* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, of which the first `bytes` are read
// and the rest are zeros (both addresses 16-byte aligned).
__device__ __forceinline__ void copy16(void* to, const void* from, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(to)), "l"(from), "r"(bytes) : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// An f32 sum of the width pass (or of the height pass where the width is
// kept) as flagship._round_u8 rounds its bf16: +0.5, clamp, truncation.
__device__ __forceinline__ uint8_t round_u8(float sum) {
  const float b = __bfloat162float(__float2bfloat16_rn(sum));
  return static_cast<uint8_t>(__float2uint_rz(fminf(fmaxf(b + 0.5f, 0.0f), 255.0f)));
}

// Output columns cc and cc + 1 of a row (`out` at cc), those below `cn`: u8
// samples rounded from the width pass's f32 sums, two at once where aligned.
__device__ __forceinline__ void store_pair(uint8_t* out, float lo_sum, float hi_sum, int cc, int cn) {
  const uint8_t lo = round_u8(lo_sum), hi = round_u8(hi_sum);
  if (cc + 1 < cn && (reinterpret_cast<uintptr_t>(out) & 1) == 0) {
    *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>(lo | (hi << 8));
  } else {
    if (cc < cn) out[0] = lo;
    if (cc + 1 < cn) out[1] = hi;
  }
}

// The same with the f32 sums kept as they are.
__device__ __forceinline__ void store_pair(float* out, float lo, float hi, int cc, int cn) {
  if (cc + 1 < cn && (reinterpret_cast<uintptr_t>(out) & 7) == 0) {
    *reinterpret_cast<float2*>(out) = make_float2(lo, hi);
  } else {
    if (cc < cn) out[0] = lo;
    if (cc + 1 < cn) out[1] = hi;
  }
}

// Start the copies of strip `d`'s window into `raw` (rows of its padded
// width, zeros past the window), of its row and column blocks' weights into
// `hw` and `ww`, and of the strip row `next` (or none) into `next_desc`. A
// source whose rows are not 16-byte aligned is copied here byte by byte
// instead. `Args` holds src and src_stride, each tile plane's source and
// bytes between its rows, and `s` (StripArgs).
template <typename Args>
__device__ void start_strip(const Args& args, const int* d, uint8_t* raw, int* hw, int* ww,
                            const int* next, int* next_desc) {
  const int hwin = d[kHwin], wwin = d[kWwin], hpad = d[kHpad], wpad = d[kWpad];
  const uint8_t* src = args.src[d[kSrc] - args.s.first];
  const long long stride = args.src_stride[d[kSrc] - args.s.first];
  const uint8_t* corner = src + d[kSr0] * stride + d[kXw0];
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(stride)) & 15) == 0;
  // threads in rows of `chunks` 16-byte items, `step` rows at a time
  const int chunks = wpad >> 4, step = kThreads / chunks;
  const int x = (threadIdx.x % chunks) << 4;
  for (int s = threadIdx.x / chunks; s < hpad && threadIdx.x < step * chunks; s += step) {
    const int bytes = s < hwin ? min(max(wwin - x, 0), 16) : 0;
    const uint8_t* from = corner + s * stride + x;
    if (aligned) {
      copy16(raw + s * wpad + x, bytes ? from : src, bytes);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i < bytes) w[i >> 2] |= static_cast<uint32_t>(__ldg(from + i)) << (8 * (i & 3));
      }
      *reinterpret_cast<uint4*>(raw + s * wpad + x) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  const int h_quads = h_entry_ints((d[kRn] + 15) >> 4, d[kKh]) >> 2;
  const int w_quads = w_entry_ints((d[kCn] + 7) >> 3, d[kKw]) >> 2;
  for (int i = threadIdx.x; i < h_quads + w_quads; i += kThreads) {
    if (i < h_quads) {
      copy16(hw + 4 * i, args.s.table + d[kHrow] + 4 * i, 16);
    } else {
      copy16(ww + 4 * (i - h_quads), args.s.table + d[kWcol] + 4 * (i - h_quads), 16);
    }
  }
  if (next != nullptr && threadIdx.x < kStripInts / 4) {
    copy16(next_desc + 4 * threadIdx.x, next + 4 * threadIdx.x, 16);
  }
  copies_commit();
}

// The lanes' places in the mma fragments and ldmatrix's addresses.
struct Lanes {
  int warp, lane;
  int gq, tq;      // the mma fragments' group and thread in group
  int lrow, lcol;  // ldmatrix: lane l addresses row (l & 7) of matrix l >> 3
  __device__ Lanes()
      : warp(threadIdx.x >> 5), lane(threadIdx.x & 31), gq(lane >> 2), tq(lane & 3),
        lrow((lane & 7) + ((lane >> 3) & 1) * 8), lcol((lane >> 4) * 8) {}
};

// The height pass of strip `d`: T[r][x] = bf16(sum_k Wh[r][k] * S[k][x])
// over each m-tile's k-tiles, for the strip's rows r and every window
// column x, from its row block's weights `hw`, for each of kCh channels (S
// and T planes `s_plane` and `t_plane` apart; rows of `spitch` bf16). A
// unit is an m-tile and two n-tiles of 8 columns, in every channel: the
// weights' fragment is loaded once for the channels' products. A warp
// runs kMaxUnits units at once with one channel, one with more. With
// kOnesLast, the last channel's S is a window of ones and is not read:
// each of its B fragments is bf16 1.0.
template <int kCh, bool kOnesLast>
__device__ __forceinline__ void height_pass(const Lanes& l, const int* d, const int* hw,
                                            const uint16_t* S, int s_plane, uint16_t* T,
                                            int t_plane, int spitch) {
  constexpr int kUnits = kCh == 1 ? kMaxUnits : 1;
  const int mtiles = (d[kRn] + 15) >> 4, hp = 16 * d[kKh] + 8;
  const uint16_t* htiles = reinterpret_cast<const uint16_t*>(hw + kHHead);
  const int npairs = d[kWpad] >> 4, units = mtiles * npairs;
  for (int u0 = l.warp; u0 < units; u0 += kWarps * kUnits) {
    // the units' tiles: rows of the weights and of the window, k-tiles
    const uint16_t* a_row[kUnits];
    const uint16_t* b_row[kUnits];
    int nk[kUnits], nk_max = 0;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int u = min(u0 + j * kWarps, units - 1);
      const int mi = u / npairs, q = u - mi * npairs;
      nk[j] = u0 + j * kWarps < units ? hw[2 + mi] : 0;
      nk_max = max(nk_max, nk[j]);
      a_row[j] = htiles + mi * 16 * hp + l.lrow * hp + l.lcol;
      b_row[j] = S + (16 * hw[mi] + l.lrow) * spitch + 16 * q + l.lcol;
    }
    float acc[kUnits][kCh][2][4] = {};
    for (int kk = 0; kk < nk_max; ++kk) {
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        if (kk < nk[j]) {
          uint32_t a[4];
          ldmatrix_x4(a, a_row[j] + 16 * kk);
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            uint32_t bf[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
            // matrices: k rows 0-7 and 8-15 of n-tile 2q, then of 2q + 1
            if (!kOnesLast || c + 1 < kCh) {
              ldmatrix_x4_trans(bf, b_row[j] + c * s_plane + 16 * kk * spitch);
            }
            mma_bf16(acc[j][c][0], a, bf);
            mma_bf16(acc[j][c][1], a, bf + 2);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int u = u0 + j * kWarps;
      if (u < units) {
        const int mi = u / npairs, q = u - mi * npairs;
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint16_t* out = T + c * t_plane + (16 * mi + l.gq) * spitch + 16 * q + 8 * n + 2 * l.tq;
            *reinterpret_cast<uint32_t*>(out) = pack_bf16(acc[j][c][n][0], acc[j][c][n][1]);
            *reinterpret_cast<uint32_t*>(out + 8 * spitch) =
                pack_bf16(acc[j][c][n][2], acc[j][c][n][3]);
          }
        }
      }
    }
  }
}

// The width pass of strip `d`: out[r][c] = sum_x T[r][x] * Ww[c][x] over
// the n-tile's k-tiles of its column block's weights `ww`, for each of kCh
// channels of T (planes `t_plane` apart), 8 output columns an n-tile, each
// warp one n-tile at a time over every m-tile and channel: the weights'
// fragment is loaded once for the channels' products. Each pair of f32
// sums of columns cc and cc + 1 of row r goes to `store(ch, r, cc, lo,
// hi)`.
template <int kCh, typename Store>
__device__ __forceinline__ void width_pass(const Lanes& l, const int* d, const int* ww,
                                           const uint16_t* T, int t_plane, int spitch,
                                           const Store& store) {
  const int rn = d[kRn], cn = d[kCn], mtiles = (rn + 15) >> 4, wp = 16 * d[kKw] + 8;
  const uint16_t* wtiles = reinterpret_cast<const uint16_t*>(ww + kWHead);
  for (int jc = l.warp; jc < (cn + 7) >> 3; jc += kWarps) {
    const int kt0 = ww[jc], nk = ww[16 + jc];
    const uint16_t* b_row = wtiles + jc * 8 * wp + (l.lane & 7) * wp + ((l.lane >> 3) & 1) * 8;
    const uint16_t* a_row = T + l.lrow * spitch + 16 * kt0 + l.lcol;
    float acc[kCh][kMaxMTiles][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t bf[2];
      ldmatrix_x2(bf, b_row + 16 * kk);
#pragma unroll
      for (int mi = 0; mi < kMaxMTiles; ++mi) {
        if (mi < mtiles) {
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            uint32_t a[4];
            ldmatrix_x4(a, a_row + c * t_plane + 16 * mi * spitch + 16 * kk);
            mma_bf16(acc[c][mi], a, bf);
          }
        }
      }
    }
    const int cc = 8 * jc + 2 * l.tq;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
#pragma unroll
      for (int mi = 0; mi < kMaxMTiles; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mi + l.gq + 8 * h;
          if (r < rn) store(c, r, cc, acc[c][mi][2 * h], acc[c][mi][2 * h + 1]);
        }
      }
    }
  }
}

// A block's walk over its strips: the body of both kernels. `Args` holds
// src and src_stride, `s` (StripArgs), and dst and dst_stride (elements
// between rows), of the type `store_pair` writes, indexed by
// `args.dst_index(d)` for strip row d.
template <typename Args>
__device__ __forceinline__ void resize_strips(const Args& args) {
  extern __shared__ __align__(16) uint8_t smem[];
  const StripArgs& sa = args.s;
  // shared memory: two sets of buffers (one being copied while the other is
  // used) of a u8 window and its row and column blocks' weights, then the
  // window in bf16 (S) and three strip rows. The height pass in bf16 (T)
  // takes the place of its strip's u8 window, widened by then. Rows of S
  // and T are an odd number of 16 bytes apart, which keeps ldmatrix's eight
  // rows in distinct banks.
  const int raw_bytes = max(sa.hpad * sa.wpad, round_up16(sa.mrows * (sa.wpad + 8) * 2));
  const int set_bytes = raw_bytes + 4 * (sa.h_ints + sa.w_ints);
  uint16_t* S = reinterpret_cast<uint16_t*>(smem + 2 * set_bytes);
  int* desc = reinterpret_cast<int*>(S + sa.hpad * (sa.wpad + 8));  // 3 x kStripInts

  const Lanes l;
  const int step = gridDim.x;
  const int* strips = sa.table + static_cast<long long>(sa.strips) * kStripInts;

  // the first strip's copies, its row read directly; the next strip's row
  // rides along
  int s = blockIdx.x;
  if (threadIdx.x < kStripInts) desc[threadIdx.x] = __ldg(strips + s * kStripInts + threadIdx.x);
  __syncthreads();
  start_strip(args, desc, smem, reinterpret_cast<int*>(smem + raw_bytes),
              reinterpret_cast<int*>(smem + raw_bytes + 4 * sa.h_ints),
              s + step < sa.n_strips ? strips + (s + step) * kStripInts : nullptr,
              desc + kStripInts);
  for (int i = 0; s < sa.n_strips; ++i, s += step) {
    const int* d = desc + (i % 3) * kStripInts;
    uint8_t* set = smem + (i & 1) * set_bytes;
    uint16_t* T = reinterpret_cast<uint16_t*>(set);
    const int* hw = reinterpret_cast<const int*>(set + raw_bytes);
    const int* ww = reinterpret_cast<const int*>(set + raw_bytes + 4 * sa.h_ints);
    copies_wait();
    __syncthreads();
    if (s + step < sa.n_strips) {
      uint8_t* next_set = smem + ((i + 1) & 1) * set_bytes;
      start_strip(args, desc + ((i + 1) % 3) * kStripInts, next_set,
                  reinterpret_cast<int*>(next_set + raw_bytes),
                  reinterpret_cast<int*>(next_set + raw_bytes + 4 * sa.h_ints),
                  s + 2 * step < sa.n_strips ? strips + (s + 2 * step) * kStripInts : nullptr,
                  desc + ((i + 2) % 3) * kStripInts);
    }

    const int hpad = d[kHpad], wpad = d[kWpad];
    const int spitch = wpad + 8;

    // the window widened to bf16, 16 samples an item, in rows of `chunks` items
    {
      const int chunks = wpad >> 4, rows_at_once = kThreads / chunks;
      const int x = (threadIdx.x % chunks) << 4;
      for (int r = threadIdx.x / chunks; r < hpad && threadIdx.x < rows_at_once * chunks;
           r += rows_at_once) {
        const uint4 v = *reinterpret_cast<const uint4*>(set + r * wpad + x);
        uint4* to = reinterpret_cast<uint4*>(S + r * spitch + x);
        to[0] = make_uint4(bf16x2_of_bytes(v.x, 0), bf16x2_of_bytes(v.x, 2),
                           bf16x2_of_bytes(v.y, 0), bf16x2_of_bytes(v.y, 2));
        to[1] = make_uint4(bf16x2_of_bytes(v.z, 0), bf16x2_of_bytes(v.z, 2),
                           bf16x2_of_bytes(v.w, 0), bf16x2_of_bytes(v.w, 2));
      }
    }
    __syncthreads();

    height_pass<1, false>(l, d, hw, S, 0, T, 0, spitch);
    __syncthreads();

    // the width pass, each output pair stored straight into its plane
    const int di = args.dst_index(d);
    auto* dst = args.dst[di];
    const long long dstride = args.dst_stride[di];
    dst += d[kDstY] * dstride + d[kDstX];
    const int cn = d[kCn];
    width_pass<1>(l, d, ww, T, 0, spitch, [&](int, int r, int cc, float lo, float hi) {
      store_pair(dst + r * dstride + cc, lo, hi, cc, cn);
    });
    __syncthreads();  // S, T, this strip's buffers and row are free again
  }
}

// Checks of a launch's strip arguments, shared by both entries.
inline bool strip_args_valid(int n, int n_strips, int strips, int first, int hpad, int wpad,
                             int mrows, int h_ints, int w_ints, int smem_bytes, int blocks) {
  return !(n <= 0 || n > kMaxPlanes || n_strips <= 0 || strips < 0 || first < 0 || hpad <= 0 ||
           wpad <= 0 || mrows <= 0 || mrows > 16 * kMaxMTiles || h_ints <= 0 || w_ints <= 0 ||
           (h_ints | w_ints) % 4 || smem_bytes <= 0 || smem_bytes > kMaxSmem || blocks <= 0 ||
           blocks > n_strips);
}

// The blocks of `kernel` an SM of the current card holds at `smem_bytes` of
// dynamic shared memory (or -1 on an error), after giving the kernel all of
// the SM's unified memory as shared memory, which a launch above 48 KB
// needs. Call it on each card before its first launch, outside a CUDA
// graph's capture.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int smem_bytes) {
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes) !=
          cudaSuccess) {
    return -1;
  }
  return per_sm;
}

}  // namespace
