// K1, K4, K5: the fused SRCNN 9-5-5 conv stack on Hopper's tensor cores, one
// kernel template over its store (the epilogue).
//
// Replaces the TPU kernel srcnn_cpp_tpu/ops/pallas_srcnn.py::_kernel_stacked
// and :_kernel, launched by _fused_call, in three instances:
//   K1 StoreU8  (srcnn_y_fused): quant=True, merge=False, with the XLA edge
//      fix-up _fix_edges_batch that supplied conv3's feature-column clamp
//      on the TPU;
//   K4 StoreBGR (srcnn_merge_fused): merge=True, i.e. IntTrim, then the
//      inverse YCrCb->BGR of Y' with the pixel's upscaled Cr/Cb
//      (_kernel_stacked :505-521), planar BGR stored directly; its TPU
//      entry's column patch (srcnn_merge_fused :746-758) has no counterpart;
//   K5 StoreF32 (srcnn_y_f32_fused): conv3 + b3 in f32, unquantized, the
//      counterpart of the legacy 8-matmul body _kernel :157.  That body
//      leaves b3 to its wrapper and, with no row-clamp plan, leaves the
//      outer 2 rows and columns at virtual-extension values.  K5 carries
//      the reference's semantics instead (b3 added, both clamps below),
//      not that TPU artefact.
// The three share one body, so they sum in the same order: quantized K5
// equals K1, and K4 equals K1 -> K3, bit for bit.
//
// What it computes, per output pixel (reference src/srcnn.cpp:189-325):
//   f1 = ReLU(conv1 9x9 1->64 (input replicate-padded by 4) + b1)
//   f2 = ReLU(conv2 1x1 64->32 (f1) + b2)
//   v  = conv3 5x5 32->1 (f2 replicate-padded by 2 at FEATURE level) + b3
// IntTrim(v) truncates toward zero, then clamps to [0, 255] before the u8
// cast.
//
// What bounds it on the H100: tensor-core issue.  In 3xTF32 the three
// stages take 18,912 MACs per output pixel (conv1 2 x 81 x 64, conv2
// 3 x 64 x 32, conv3 3 x 32 x 25) against 1 byte in and 1 to 4 bytes out.
//
// What the design does about it:
// * every stage is a GEMM over the f2 halo positions of a tile, on
//   mma.sync.m16n8k8 tf32 with fp32 accumulation.  fp32 accuracy comes from
//   the 3xTF32 split: hi = x with its low 13 bits cleared, lo = x - hi
//   (exact in fp32, read as tf32 by the mma), and a*b ~ al*bh + ah*bl +
//   ah*bh.  The u8 input is exact in tf32, so conv1 takes 2 products;
// * conv1: A is the im2col of the input window, built as fragments straight
//   from shared memory (K = 81 taps padded to 88, N = 64);
// * conv2: the conv1 accumulators become conv2's A fragments in registers,
//   so f1 never leaves registers.  An m16n8 accumulator holds columns 2t and
//   2t+1 where the A operand wants columns t and t+4; the packed w2 carries
//   that permutation of its K index (ops/cuda_srcnn.py::c_to_a_perm), so no
//   shuffle is needed.  conv3's partials take f2 the same way;
// * conv3: per-tap partials P = f2 [pos x 32] . W3 [32 x 25, padded to 32],
//   the TPU kernel's own form (pallas_srcnn.py:20-22), into shared memory;
//   then a 25-add stencil in a fixed tap order, plus b3, and the store;
// * f2 is computed at feature coordinates clamped to the image on BOTH
//   axes, which is exactly the reference's conv3 feature clamp, so no edge
//   pass exists; conv1 reads its input at clamped coordinates;
// * one persistent block per SM (the launcher's grid) walks over the tiles.
//   The packed weights (hi/lo planes in fragment order, 70 KB) are staged in
//   shared memory once per block; the next tile's input window is copied
//   with cp.async while the current one computes.  Each warp takes two m16
//   row tiles at a time, so each B fragment read serves 32 positions.
//
// The tile plan (tile, shared-memory bytes, grid) is computed by
// ops/cuda_srcnn.py::conv_tile_plan and handed to the launcher, which
// refuses a plan that does not match the constants below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"

namespace {

constexpr int TH = 36, TW = 28;             // output tile
constexpr int HH = TH + 4, HW = TW + 4;     // f2 halo tile (40 x 32)
constexpr int IH = TH + 12, IW = TW + 12;   // input window (48 x 40)
constexpr int IWS = 52;                     // float window row stride: the
                                            // conv1 A reads wrap a tap row
                                            // at +IWS-8, off the banks of
                                            // the unwrapped lanes
constexpr int NPOS = HH * HW;               // 1280 f2 positions
constexpr int PSTR = NPOS + 4;              // partial plane stride (banks)
constexpr int NTHREADS = 256, NWARPS = NTHREADS / 32;
constexpr int PAIRS = NPOS / 32;            // pairs of m16 row tiles
constexpr int WORDS = 11;                   // 4-byte words per window row
constexpr int BROW = 4 * WORDS + 4;         // byte window row stride
static_assert(NPOS % 32 == 0 && PAIRS % NWARPS == 0, "warp work split");
static_assert(4 * WORDS >= IW + 3, "a window row plus its misalignment");

// packed weight layout (floats); must match ops/cuda_srcnn.py::pack_weights.
// A B-fragment block holds, for each of the 32 lanes (g = lane / 4,
// t = lane % 4), the float4 {hi(k=t, n=g), hi(k=t+4, n=g), lo(k=t, n=g),
// lo(k=t+4, n=g)} of one k8 x n8 tile of the [K][N] weight matrix.
constexpr int K1P = 88;                     // conv1 taps 81, padded to 88
constexpr int W1_OFF = 0;                   // [11 k][8 n] fragment blocks
constexpr int B1_OFF = W1_OFF + (K1P / 8) * 8 * 128;
constexpr int W2_OFF = B1_OFF + 64;         // [8 k][4 n], K permuted
constexpr int B2_OFF = W2_OFF + 8 * 4 * 128;
constexpr int W3_OFF = B2_OFF + 32;         // [4 k][4 n], K permuted, N 25->32
constexpr int B3_OFF = W3_OFF + 4 * 4 * 128;  // [1], padded to 4
constexpr int WTOTAL = B3_OFF + 4;
static_assert(WTOTAL == 17508, "packed weight size");
static_assert(W2_OFF % 4 == 0 && W3_OFF % 4 == 0 && B1_OFF % 2 == 0 &&
              B2_OFF % 2 == 0 && WTOTAL % 4 == 0, "vector alignment");

constexpr int WIN_OFF = WTOTAL;                   // float window [IH][IWS]
constexpr int P_OFF = WIN_OFF + IH * IWS;         // partials [25][PSTR]
constexpr int BYTES_OFF = P_OFF + 25 * PSTR;      // 2 byte windows [IH][BROW]
constexpr size_t SMEM_BYTES = sizeof(float) * BYTES_OFF + 2 * IH * BROW;
static_assert(SMEM_BYTES == 213024, "shared memory of the tile plan");
static_assert(SMEM_BYTES <= 232448, "one block's shared memory on sm_90");

__device__ __forceinline__ uint8_t int_trim(float v) {
  return (uint8_t)fminf(fmaxf(truncf(v), 0.f), 255.f);
}

// The stores: v = conv3 + b3 at output pixel (oy, ox) of frame b.
struct StoreU8 {    // K1: IntTrim(v) into out [B, H, W] u8
  uint8_t* out;
  __device__ void operator()(int b, int oy, int ox, int H, int W,
                             float v) const {
    out[((size_t)b * H + oy) * W + ox] = int_trim(v);
  }
};

struct StoreF32 {   // K5: v into out [B, H, W] f32
  float* out;
  __device__ void operator()(int b, int oy, int ox, int H, int W,
                             float v) const {
    out[((size_t)b * H + oy) * W + ox] = v;
  }
};

struct StoreBGR {   // K4: BGR of (IntTrim(v), Cr, Cb) into out [B, 3, H, W] u8
  const uint8_t* up;  // upscaled YCrCb [B, 3, H, W]
  uint8_t* out;
  __device__ void operator()(int b, int oy, int ox, int H, int W,
                             float v) const {
    const long long plane = (long long)H * W;
    const long long p = (long long)b * 3 * plane + (long long)oy * W + ox;
    srcnn_color::store_bgr(int_trim(v), up[p + plane], up[p + 2 * plane],
                           out + p, plane);
  }
};

// D += A . B on one m16n8k8 tile; A and B hold tf32 bit patterns.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 split: hi keeps the tf32 bits of x; lo = x - hi is exact in fp32.
// A bit mask, not a cvt round trip, so the compiler cannot fold lo to 0.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// ReLU and split of one m16n8 accumulator tile, reordered into the A
// fragment of the next stage's k8 step: a = {c0, c2, c1, c3}.
__device__ __forceinline__ void relu_split(const float (&c)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(fmaxf(c[0], 0.f), hi[0], lo[0]);
  split(fmaxf(c[2], 0.f), hi[1], lo[1]);
  split(fmaxf(c[1], 0.f), hi[2], lo[2]);
  split(fmaxf(c[3], 0.f), hi[3], lo[3]);
}

// Window offset of conv1 tap k (row-major ky * 9 + kx); padded taps read
// the window's origin, which their zero weights cancel.
__device__ __forceinline__ int tap_offset(int k) {
  return k < 81 ? (k / 9) * IWS + k % 9 : 0;
}

struct Tile {
  int b, oy0, ox0;
};

__device__ __forceinline__ Tile tile_origin(int tile, int H, int W) {
  const int tx_n = (W + TW - 1) / TW, ty_n = (H + TH - 1) / TH;
  const int tx = tile % tx_n, rest = tile / tx_n;
  return Tile{rest / ty_n, (rest % ty_n) * TH, tx * TW};
}

// The input window of a tile, rows clamp(oy0-6+r), columns x_lo..x_hi of
// the image (clamp(ox0-6+c) for c in [0, IW)), as raw bytes: row r holds
// the aligned 4-byte words that cover the row's bytes, so byte x of the
// image row lands at r * BROW + mis + (x - x_lo), mis the misalignment of
// the row's first byte.  Each word holds at least one byte of the plane,
// so no copy leaves the plane's 4-byte-aligned span.
__device__ __forceinline__ const uint8_t* window_row(
    const uint8_t* src, int r, const Tile& t, int H, int W) {
  const int gy = min(max(t.oy0 - 6 + r, 0), H - 1);
  return src + (size_t)gy * W + max(t.ox0 - 6, 0);
}

__device__ void copy_window_async(const uint8_t* src, const Tile& t, int H,
                                  int W, uint8_t* buf) {
  const int x_lo = max(t.ox0 - 6, 0), x_hi = min(t.ox0 + TW + 5, W - 1);
  for (int i = threadIdx.x; i < IH * WORDS; i += NTHREADS) {
    const int r = i / WORDS, w = i - r * WORDS;
    const uint8_t* first = window_row(src, r, t, H, W);
    const uintptr_t a = reinterpret_cast<uintptr_t>(first) & ~uintptr_t(3);
    const uintptr_t word = a + 4 * w;
    if (word <= reinterpret_cast<uintptr_t>(first + (x_hi - x_lo))) {
      const uint32_t dst = static_cast<uint32_t>(
          __cvta_generic_to_shared(buf + r * BROW + 4 * w));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(word));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <class Store>
__global__ void __launch_bounds__(NTHREADS, 1)
srcnn_conv_kernel(const uint8_t* __restrict__ y, long long frame_stride,
                  const float* __restrict__ wpack, int B, int H, int W,
                  Store store) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // packed weights
  const float4* w4 = smem4;
  float* win = ws + WIN_OFF;                     // input window, f32
  float* part = ws + P_OFF;                      // conv3 partials [tap][pos]
  uint8_t* bytes = reinterpret_cast<uint8_t*>(ws + BYTES_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);

  const float4* wp4 = reinterpret_cast<const float4*>(wpack);
  for (int i = tid; i < WTOTAL / 4; i += NTHREADS) smem4[i] = wp4[i];

  int tile = blockIdx.x, cur = 0;
  if (tile < ntiles) {
    const Tile t0 = tile_origin(tile, H, W);
    copy_window_async(y + (size_t)t0.b * frame_stride, t0, H, W, bytes);
  }
  for (; tile < ntiles; tile += gridDim.x, cur ^= 1) {
    const Tile tl = tile_origin(tile, H, W);
    const uint8_t* src = y + (size_t)tl.b * frame_stride;
    const int oy0 = tl.oy0, ox0 = tl.ox0;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();   // this tile's bytes landed; last tile's reads done

    // the float window, at input coordinates clamped to the image
    {
      const uint8_t* buf = bytes + cur * IH * BROW;
      const int x_lo = max(ox0 - 6, 0);
      for (int i = tid; i < IH * IW; i += NTHREADS) {
        const int r = i / IW, c = i - r * IW;
        const int mis = (int)(reinterpret_cast<uintptr_t>(
                                  window_row(src, r, tl, H, W)) & 3);
        const int gx = min(max(ox0 - 6 + c, 0), W - 1);
        win[r * IWS + c] = (float)buf[r * BROW + mis + gx - x_lo];
      }
    }
    __syncthreads();
    if (tile + (int)gridDim.x < ntiles) {   // prefetch the next window
      const Tile nx = tile_origin(tile + gridDim.x, H, W);
      copy_window_async(y + (size_t)nx.b * frame_stride, nx, H, W,
                        bytes + (cur ^ 1) * IH * BROW);
    }

    // conv1 -> conv2 -> conv3 partials, two m16 tiles (32 halo positions)
    // per warp at a time.  Halo position p = i * HW + j holds f2 at feature
    // coordinate (clamp(oy0-2+i), clamp(ox0-2+j)); its conv1 window starts
    // at window row/col clamp(...) - (oy0|ox0) + 2.
    for (int pr = warp; pr < PAIRS; pr += NWARPS) {
      const int p0 = pr * 32;
      int base[2][2];   // [m16 tile][row g or g+8]
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + 16 * m + 8 * h + g;
          const int i = p / HW, j = p - (p / HW) * HW;
          const int wr = min(max(oy0 - 2 + i, 0), H - 1) - oy0 + 2;
          const int wc = min(max(ox0 - 2 + j, 0), W - 1) - ox0 + 2;
          base[m][h] = wr * IWS + wc;
        }

      // conv1: 11 k8 steps x 8 n8 tiles, x . w1lo + x . w1hi
      float acc1[2][8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 bb = *reinterpret_cast<const float2*>(
            ws + B1_OFF + 8 * n + 2 * t);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          acc1[m][n][0] = bb.x; acc1[m][n][1] = bb.y;
          acc1[m][n][2] = bb.x; acc1[m][n][3] = bb.y;
        }
      }
#pragma unroll
      for (int ks = 0; ks < K1P / 8; ++ks) {
        const int o0 = tap_offset(8 * ks + t), o1 = tap_offset(8 * ks + t + 4);
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m][0] = __float_as_uint(win[base[m][0] + o0]);
          a[m][1] = __float_as_uint(win[base[m][1] + o0]);
          a[m][2] = __float_as_uint(win[base[m][0] + o1]);
          a[m][3] = __float_as_uint(win[base[m][1] + o1]);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 bw = w4[W1_OFF / 4 + (ks * 8 + n) * 32 + lane];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma(acc1[m][n], a[m], __float_as_uint(bw.z), __float_as_uint(bw.w));
            mma(acc1[m][n], a[m], __float_as_uint(bw.x), __float_as_uint(bw.y));
          }
        }
      }

      // conv2: f1 = ReLU(acc1) split into A fragments; al.bh + ah.bl + ah.bh
      float acc2[2][4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 bb = *reinterpret_cast<const float2*>(
            ws + B2_OFF + 8 * n + 2 * t);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          acc2[m][n][0] = bb.x; acc2[m][n][1] = bb.y;
          acc2[m][n][2] = bb.x; acc2[m][n][3] = bb.y;
        }
      }
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) relu_split(acc1[m][ks], ah[m], al[m]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float4 bw = w4[W2_OFF / 4 + (ks * 4 + n) * 32 + lane];
          const uint32_t h0 = __float_as_uint(bw.x), h1 = __float_as_uint(bw.y);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma(acc2[m][n], al[m], h0, h1);
            mma(acc2[m][n], ah[m], __float_as_uint(bw.z), __float_as_uint(bw.w));
            mma(acc2[m][n], ah[m], h0, h1);
          }
        }
      }

      // conv3 per-tap partials: P = ReLU(acc2) . W3, 3 products
      float acc3[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc3[m][n][r] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) relu_split(acc2[m][ks], ah[m], al[m]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float4 bw = w4[W3_OFF / 4 + (ks * 4 + n) * 32 + lane];
          const uint32_t h0 = __float_as_uint(bw.x), h1 = __float_as_uint(bw.y);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma(acc3[m][n], al[m], h0, h1);
            mma(acc3[m][n], ah[m], __float_as_uint(bw.z), __float_as_uint(bw.w));
            mma(acc3[m][n], ah[m], h0, h1);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int tap = 8 * n + 2 * t, p = p0 + 16 * m + g;
          if (tap < 25) {
            part[tap * PSTR + p] = acc3[m][n][0];
            part[tap * PSTR + p + 8] = acc3[m][n][2];
          }
          if (tap + 1 < 25) {
            part[(tap + 1) * PSTR + p] = acc3[m][n][1];
            part[(tap + 1) * PSTR + p + 8] = acc3[m][n][3];
          }
        }
    }
    __syncthreads();

    // the 25-tap stencil over the partials, in tap order, + b3; the store
    const float b3 = ws[B3_OFF];
    for (int q = tid; q < TH * TW; q += NTHREADS) {
      const int r = q / TW, c = q - r * TW;
      const int oy = oy0 + r, ox = ox0 + c;
      if (oy >= H || ox >= W) continue;
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 5; ++dy)
#pragma unroll
        for (int dx = 0; dx < 5; ++dx)
          acc += part[(dy * 5 + dx) * PSTR + (r + dy) * HW + c + dx];
      store(tl.b, oy, ox, H, W, acc + b3);
    }
  }
}

template <class Store>
int launch(const uint8_t* y, long long frame_stride, const float* wpack,
           int B, int H, int W, int tile_h, int tile_w, int grid,
           int smem_bytes, Store store, void* stream) {
  if (tile_h != TH || tile_w != TW || smem_bytes != (int)SMEM_BYTES ||
      grid <= 0)
    return (int)cudaErrorInvalidValue;   // a plan for another kernel
  cudaError_t err = cudaFuncSetAttribute(
      srcnn_conv_kernel<Store>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  srcnn_conv_kernel<Store><<<grid, NTHREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(y, frame_stride, wpack,
                                                     B, H, W, store);
  return (int)cudaGetLastError();
}

}  // namespace

// y: B planes of H x W u8, plane b at y + b * frame_stride (rows contiguous);
// wpack: WTOTAL floats on the device, 16-byte aligned; out: B x H x W.
// (tile_h, tile_w, grid, smem_bytes): ops/cuda_srcnn.py::conv_tile_plan.
extern "C" int srcnn_conv_u8(const uint8_t* y, long long frame_stride,
                             const float* wpack, uint8_t* out, int B, int H,
                             int W, int tile_h, int tile_w, int grid,
                             int smem_bytes, void* stream) {
  return launch(y, frame_stride, wpack, B, H, W, tile_h, tile_w, grid,
                smem_bytes, StoreU8{out}, stream);
}

extern "C" int srcnn_conv_f32(const uint8_t* y, long long frame_stride,
                              const float* wpack, float* out, int B, int H,
                              int W, int tile_h, int tile_w, int grid,
                              int smem_bytes, void* stream) {
  return launch(y, frame_stride, wpack, B, H, W, tile_h, tile_w, grid,
                smem_bytes, StoreF32{out}, stream);
}

// up, out: B x 3 x H x W u8, contiguous; Y is read from up[:, 0].
extern "C" int srcnn_conv_merge_u8(const uint8_t* up, const float* wpack,
                                   uint8_t* out, int B, int H, int W,
                                   int tile_h, int tile_w, int grid,
                                   int smem_bytes, void* stream) {
  return launch(up, 3LL * H * W, wpack, B, H, W, tile_h, tile_w, grid,
                smem_bytes, StoreBGR{up, out}, stream);
}
