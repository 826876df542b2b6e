// K2: fused pre-pass, planar BGR u8 [B,3,H,W] -> upscaled YCrCb u8 [B,3,OH,OW].
//
// Replaces the TPU kernel srcnn_cpp_tpu/ops/pallas_resize.py::_kernel
// (launched by _fused_pre_call through _apply_fused_pre, called from
// pre_upscale_fused).
//
// What it computes, bit-exact with ycrcb = bgr2ycrcb_u8_planar(bgr) followed
// by resize_bicubic_u8(ycrcb, (OH, OW)) (reference src/srcnn.cpp:509 and
// :570-583, OpenCV 4.6 INTER_CUBIC):
// * color: OpenCV's 14-bit fixed-point BGR->YCrCb in int32, clipped to u8;
// * horizontal pass: 4 integer taps through the clamped column table
//   (xi, xic), an exact int32 sum;
// * vertical pass: 4 float32 taps (yi, yfc), right to left (3,2,1,0), every
//   product and every sum rounded on its own, then round half-to-even and
//   clip to [0, 255].
// nvcc contracts a*b+c into one FMA by default, which rounds once and breaks
// bit identity on exact .5 boundaries; the vertical chain therefore uses the
// __fmul_rn / __fadd_rn intrinsics, which are never contracted.
//
// What bounds it on the H100.  Not its bytes: 6.2 MB in and 24.9 MB out at
// x2 on 4 x 540x960 take 9.3 us at 3.35 TB/s, and the kernel takes about
// three times that.  It is bound by instruction issue and by latency.  Per
// output pixel the vertical chain alone is 21 float operations that cannot
// fuse, the rounding and packing ~11 more, and the window and horizontal
// pass ~25 integer operations at half rate; each block runs its window
// loads, its horizontal pass and its vertical pass one after the other,
// so the latency of the first two is hidden only by the other block on the
// SM.  The former design added, per output pixel, 12 int->float
// conversions, 3 roundings and 3 float->int conversions (conversion-class
// instructions, 16 a clock on an SM against 128 float multiplies) and ~27
// load/store instructions (12 LDS.32, 3 one-byte stores, the row taps
// re-read per pixel).  This design:
//   * converts each horizontal sum to float once, where it is made
//     (exact: |sum| < 2^20); shared memory holds the float sums;
//   * rounds and clamps without a conversion: clamp in float, add 1.5*2^23
//     (__fadd_rn rounds half to even, as rintf), take the low byte;
//   * gives a thread CPT = 4 adjacent output columns: one 16-byte shared
//     load per tap row and channel (the three channels of a row and four
//     columns are adjacent, so the three loads share one address), one
//     4-byte global store per channel and row where the row is
//     word-aligned (bytes only at a ragged tile edge), the row taps and
//     weights staged in shared memory once per tile;
//   * keeps one word per window pixel {Y, Cr, Cb, 0}, so a horizontal tap
//     is one 4-byte shared load for the three channels, and sums the taps
//     with two-way 16x8-bit dot products (dp2a) after one byte permute per
//     channel pair; the window is read with 4-byte loads where W % 4 == 0;
//   * persists: as many blocks as the card holds walk the tiles, and each
//     thread's first U window loads of the next tile are in flight while
//     the current tile's rows are made.
// Keeping the last four tap rows of a thread's rows in registers (a ring
// that reloads only the rows a shifted row adds) was built and measured:
// its data-dependent branches cost more issue than the shared loads it
// saves, so each row loads its four tap rows.  The vertical chain cannot
// use tensor cores: it must round every product on its own.  The
// horizontal pass could only with its 12-bit signed coefficients split
// into two int8 halves (exact in int32); that is untried.
//
// The design: a tile of TH x TW output pixels (TW <= 128, TH = WARPS * R).
// Its input window comes from the tap tables themselves: rows y0 ..
// y0+WH-1 and columns x0 .. x0+WW-1, where (x0, y0) is the smallest tap of
// the tile's columns and rows and (WW, WH) the largest span over all tiles,
// all planned on the host (ops/cuda_resize.py::pre_pass_plan).  The tables
// clamp, so the replicated border and every scale come for free.  Per tile:
//   1. each window pixel is converted to YCrCb once, into shared memory;
//   2. the horizontal integer pass runs once per window row and output
//      column (thread t owns column t % TW), into float sums in shared
//      memory;
//   3. warp w walks output rows w*R .. w*R+R-1, lane l owns columns
//      4l .. 4l+3: the vertical float chain, rounding, one store per
//      channel and row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SHIFT = 14, HALF = 1 << (SHIFT - 1), DELTA = 128 << SHIFT;
constexpr int R2Y = 4899, G2Y = 9617, B2Y = 1868, R2CR = 11682, B2CB = 9241;
constexpr int WARPS = 8, THREADS = 32 * WARPS;  // a block: TH = WARPS * R
constexpr int CPT = 4;                          // output columns per thread
constexpr int TW_MAX = 32 * CPT;                // one warp spans the tile
constexpr int MIN_BLOCKS = 2;                   // resident blocks per SM
constexpr int U = 4;             // window items a thread reads a tile ahead
constexpr int SMEM_MAX = 227 * 1024;
constexpr float RND = 12582912.f;               // 1.5 * 2^23

// min(max(v, 0), 255) in one instruction (sm_90's max(min(v, 255), 0))
__device__ __forceinline__ int clamp_u8(int v) {
  return __vimin_s32_relu(v, 255);
}

// One pixel's YCrCb as the word {Y, Cr, Cb, 0}.  Y needs no clamp: its
// weights are positive and sum to 2^14, so it lies in [0, 255].
__device__ __forceinline__ uint32_t ycc_word(int bb, int gg, int rr) {
  const int yv = (bb * B2Y + gg * G2Y + rr * R2Y + HALF) >> SHIFT;
  const int cr = clamp_u8(((rr - yv) * R2CR + DELTA + HALF) >> SHIFT);
  const int cb = clamp_u8(((bb - yv) * B2CB + DELTA + HALF) >> SHIFT);
  return (uint32_t)yv | (uint32_t)cr << 8 | (uint32_t)cb << 16;
}

// c + the signed 16-bit halves of a times the unsigned bytes 0,1 (lo) or
// 2,3 (hi) of b.
__device__ __forceinline__ int dp2a_lo(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp2a.lo.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ int dp2a_hi(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp2a.hi.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// clip(rint(v), 0, 255) as the low byte of the result (bit-equal to rintf,
// fminf/fmaxf and the cast for every float v).
__device__ __forceinline__ uint32_t round_u8(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.f), 255.f), RND));
}

struct Taps {      // the float sums of one tap row: 3 channels x CPT columns
  float4 c[3];
};

// The sums of window row `row` at a thread's columns: hs holds, per row,
// groups of 4 columns as {Y x4, Cr x4, Cb x4}, so the three loads share
// one address.
__device__ __forceinline__ Taps load_taps(const float* hcol, int row,
                                          int TW) {
  const float4* p = reinterpret_cast<const float4*>(hcol + row * 3 * TW);
  return {{p[0], p[1], p[2]}};
}

// The vertical chain of one channel and column, taps 3, 2, 1, 0.
__device__ __forceinline__ uint32_t chain(float h0, float h1, float h2,
                                          float h3, float4 f) {
  float v = __fmul_rn(h3, f.w);
  v = __fadd_rn(__fmul_rn(h2, f.z), v);
  v = __fadd_rn(__fmul_rn(h1, f.y), v);
  v = __fadd_rn(__fmul_rn(h0, f.x), v);
  return round_u8(v);
}

__device__ __forceinline__ uint32_t chain4(float4 h0, float4 h1, float4 h2,
                                           float4 h3, float4 f) {
  const uint32_t a = chain(h0.x, h1.x, h2.x, h3.x, f),
                 b = chain(h0.y, h1.y, h2.y, h3.y, f),
                 c = chain(h0.z, h1.z, h2.z, h3.z, f),
                 d = chain(h0.w, h1.w, h2.w, h3.w, f);
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// One output row of CPT columns, three channels, from the sums of its four
// tap rows: the twelve chains first (independent, so they interleave), then
// one 4-byte store per channel where the row is word-aligned and the
// columns are whole, else bytes.
__device__ __forceinline__ void store_row(const Taps& h0, const Taps& h1,
                                          const Taps& h2, const Taps& h3,
                                          float4 f, uint8_t* o,
                                          long long oplane, bool full, int c0,
                                          int tw) {
  uint32_t v[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    v[ch] = chain4(h0.c[ch], h1.c[ch], h2.c[ch], h3.c[ch], f);
  if (full && ((reinterpret_cast<uintptr_t>(o) | oplane) & 3) == 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      *reinterpret_cast<uint32_t*>(o + ch * oplane) = v[ch];
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (c0 + j < tw) o[ch * oplane + j] = (uint8_t)(v[ch] >> 8 * j);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
pre_pass_kernel(const uint8_t* __restrict__ bgr, const int4* __restrict__ xi,
                const int4* __restrict__ xic, const int4* __restrict__ yi,
                const float4* __restrict__ yfc, const int* __restrict__ x0s,
                const int* __restrict__ y0s, uint8_t* __restrict__ out,
                int B, int H, int W, int OH, int OW, int TH, int TW, int WH,
                int WW, int R) {
  extern __shared__ float4 smem4[];
  // the float sums, [WH][TW / 4][3][4]: per row and 4 columns, Y, Cr, Cb
  float* hs = reinterpret_cast<float*>(smem4);
  const int WP = (WW + 6) & ~3;   // window pitch: WW + 3 of word alignment
  uint32_t* win = reinterpret_cast<uint32_t*>(hs + 3 * WH * TW);  // [WH][WP]
  int4* rtaps = reinterpret_cast<int4*>(win + WH * WP);    // [2][TH] taps - y0
  float4* rcoefs = reinterpret_cast<float4*>(rtaps + 2 * TH);  // [2][TH]

  const int t = threadIdx.x;
  const int gx = (OW + TW - 1) / TW, gxy = gx * ((OH + TH - 1) / TH);
  const int ntiles = gxy * B;
  const size_t plane = (size_t)H * W;
  const long long oplane = (long long)OH * OW;
  // 4-byte loads when every image row starts on a word
  const bool vec =
      (W & 3) == 0 && (reinterpret_cast<uintptr_t>(bgr) & 3) == 0;

  // A tile's window: its first row and column, rows, words or pixels a row
  struct Win {
    int y0, xb, wh, n;
  };
  auto window = [&](int wx, int wy) {
    const int xb = vec ? wx & ~3 : wx;
    const int wc = min(WW + wx - xb, W - xb);
    return Win{wy, xb, min(WH, H - wy), vec ? (wc + 3) >> 2 : wc};
  };
  // the three plane words (or bytes) of window item (r, j) of image b
  auto fetch = [&](const Win& w, int b, int r, int j, uint32_t* v) {
    const uint8_t* p =
        bgr + (size_t)b * 3 * plane + (size_t)(w.y0 + r) * W + w.xb;
    if (vec) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(p) + j;
      v[0] = __ldg(q);
      v[1] = __ldg(q + (plane >> 2));
      v[2] = __ldg(q + (plane >> 1));
    } else {
      v[0] = __ldg(p + j);
      v[1] = __ldg(p + j + plane);
      v[2] = __ldg(p + j + 2 * plane);
    }
  };
  auto convert = [&](int r, int j, const uint32_t* v) {
    if (vec) {
      uint4 c;
      c.x = ycc_word(v[0] & 255, v[1] & 255, v[2] & 255);
      c.y = ycc_word(v[0] >> 8 & 255, v[1] >> 8 & 255, v[2] >> 8 & 255);
      c.z = ycc_word(v[0] >> 16 & 255, v[1] >> 16 & 255, v[2] >> 16 & 255);
      c.w = ycc_word(v[0] >> 24, v[1] >> 24, v[2] >> 24);
      *reinterpret_cast<uint4*>(win + r * WP + 4 * j) = c;
    } else {
      win[r * WP + j] = ycc_word(v[0], v[1], v[2]);
    }
  };
  // a thread's window items: t, t + THREADS, ... in row-major order
  struct Item {
    int r, j, dr, dj;
  };
  auto first_item = [&](const Win& w) {
    const int r = t / w.n, dr = THREADS / w.n;
    return Item{r, t - r * w.n, dr, THREADS - dr * w.n};
  };
  auto next_item = [](Item& i, const Win& w) {
    i.r += i.dr, i.j += i.dj;
    if (i.j >= w.n) i.j -= w.n, ++i.r;
  };
  // the first U window items of tile k, read ahead of it
  uint32_t ahead[U][3];
  auto read_ahead = [&](int k, int x0, int y0) {
    const Win w = window(x0, y0);
    Item i = first_item(w);
#pragma unroll
    for (int u = 0; u < U; ++u, next_item(i, w))
      if (i.r < w.wh) fetch(w, k / gxy, i.r, i.j, ahead[u]);
  };

  // Blocks persist: block i computes tiles i, i + gridDim.x, ...  While a
  // tile's vertical pass runs, the next tile's first window items are
  // already in flight, and its origins before that.
  int k = blockIdx.x;
  if (k >= ntiles) return;
  int x0 = x0s[k % gx], y0 = y0s[k % gxy / gx];
  read_ahead(k, x0, y0);
  for (int it = 0; k < ntiles; ++it, k += gridDim.x) {
    const int b = k / gxy, bx = k % gx, by = k % gxy / gx;
    const int ox0 = bx * TW, oy0 = by * TH;
    const int tw = min(TW, OW - ox0), th = min(TH, OH - oy0);
    const Win w = window(x0, y0);
    int4* rtap = rtaps + (it & 1) * TH;
    float4* rcoef = rcoefs + (it & 1) * TH;

    // step 2's column taps and step 3's row taps, in flight during step 1
    const int hc = t & (TW - 1);
    int4 cx = make_int4(0, 0, 0, 0), kx = cx;
    if (hc < tw) {
      cx = __ldg(xi + ox0 + hc);
      kx = __ldg(xic + ox0 + hc);
    }
    if (t < th) {
      const int4 ty = __ldg(yi + oy0 + t);
      rtap[t] = make_int4(ty.x - y0, ty.y - y0, ty.z - y0, ty.w - y0);
      rcoef[t] = __ldg(yfc + oy0 + t);
    }

    // 1. the window, converted to YCrCb once per pixel: the items read
    //    ahead, then any beyond them
    {
      Item i = first_item(w);
#pragma unroll
      for (int u = 0; u < U; ++u, next_item(i, w))
        if (i.r < w.wh) convert(i.r, i.j, ahead[u]);
      for (; i.r < w.wh; next_item(i, w)) {
        uint32_t v[3];
        fetch(w, b, i.r, i.j, v);
        convert(i.r, i.j, v);
      }
    }
    __syncthreads();

    // the next tile's origins
    const int kn = k + gridDim.x;
    if (kn < ntiles) {
      x0 = x0s[kn % gx];
      y0 = y0s[kn % gxy / gx];
    }

    // 2. the horizontal pass, once per window row and output column: the
    //    int32 sums of the three channels, converted to float once
    if (hc < tw) {
      const int c0 = cx.x - w.xb, c1 = cx.y - w.xb, c2 = cx.z - w.xb,
                c3 = cx.w - w.xb;
      const uint32_t k01 = (kx.x & 0xffff) | (uint32_t)kx.y << 16,
                     k23 = (kx.z & 0xffff) | (uint32_t)kx.w << 16;
      const int step = THREADS / TW;
      int r = t / TW;
      const uint32_t* row = win + r * WP;
      float* o = hs + r * 3 * TW + (hc >> 2) * 12 + (hc & 3);
#pragma unroll 2
      for (; r < w.wh; r += step, row += step * WP, o += step * 3 * TW) {
        const uint32_t w0 = row[c0], w1 = row[c1], w2 = row[c2], w3 = row[c3];
        // bytes {Y0, Y1, Cr0, Cr1}, {Y2, Y3, Cr2, Cr3}; {Cb0, Cb1, ...},
        // {..., Cb2, Cb3}
        const uint32_t p01 = __byte_perm(w0, w1, 0x5140),
                       p23 = __byte_perm(w2, w3, 0x5140),
                       q01 = __byte_perm(w0, w1, 0x0062),
                       q23 = __byte_perm(w2, w3, 0x6200);
        o[0] = __int2float_rn(dp2a_lo(k01, p01, dp2a_lo(k23, p23, 0)));
        o[4] = __int2float_rn(dp2a_hi(k01, p01, dp2a_hi(k23, p23, 0)));
        o[8] = __int2float_rn(dp2a_lo(k01, q01, dp2a_hi(k23, q23, 0)));
      }
    }
    __syncthreads();

    // the next tile's window items, read while this tile's rows are made
    if (kn < ntiles) read_ahead(kn, x0, y0);

    // 3. the vertical pass: R rows of CPT columns per thread
    const int c0 = CPT * (t & 31);
    const int rb = (t >> 5) * R, re = min(rb + R, th);
    if (c0 >= tw || rb >= re) continue;
    uint8_t* o =
        out + (size_t)b * 3 * oplane + (size_t)(oy0 + rb) * OW + ox0 + c0;
    const bool full = c0 + CPT <= tw;
    const float* const hcol = hs + 3 * c0;
    for (int r = rb; r < re; ++r, o += OW) {
      const int4 ty = rtap[r];
      store_row(load_taps(hcol, ty.x, TW), load_taps(hcol, ty.y, TW),
                load_taps(hcol, ty.z, TW), load_taps(hcol, ty.w, TW),
                rcoef[r], o, oplane, full, c0, tw);
    }
  }
}

int smem_needed(int TH, int TW, int WH, int WW) {
  return 3 * WH * TW * 4 + WH * ((WW + 6) & ~3) * 4 + 2 * TH * 32;
}

// Lets the kernel take up to SMEM_MAX of dynamic shared memory on the
// current device, once per device (not a stream operation, so a launch
// inside a CUDA graph capture does not repeat it).
cudaError_t allow_smem() {
  static bool allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || allowed[dev]) return err;
  err = cudaFuncSetAttribute(pre_pass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  allowed[dev] = err == cudaSuccess;
  return err;
}

}  // namespace

// The blocks of pre_pass_kernel the current device holds at once with
// smem_bytes of shared memory each (SMs times resident blocks per SM),
// remembered per device and size: the launcher's grid, at most.
extern "C" int pre_pass_resident_blocks(int smem_bytes, int* slots) {
  static int cache_dev[8], cache_smem[8], cache_slots[8], used;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < used; ++i)
    if (cache_dev[i] == dev && cache_smem[i] == smem_bytes) {
      *slots = cache_slots[i];
      return (int)cudaSuccess;
    }
  err = allow_smem();
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pre_pass_kernel, THREADS, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  *slots = sms * per_sm;
  const int i = used < 8 ? used++ : 0;
  cache_dev[i] = dev, cache_smem[i] = smem_bytes, cache_slots[i] = *slots;
  return (int)cudaSuccess;
}

// bgr: B x 3 x H x W u8, contiguous; xi/xic: OW x 4 int32; yi: OH x 4 int32;
// yfc: OH x 4 float32 (all contiguous, 16-byte aligned); x0s: ceil(OW/TW)
// and y0s: ceil(OH/TH) int32 window origins; out: B x 3 x OH x OW.
// (TH, TW, WH, WW, smem_bytes): ops/cuda_resize.py::pre_pass_plan; a tile
// is WARPS * R rows, at most THREADS (one thread stages each row's taps).
extern "C" int pre_pass_u8(const uint8_t* bgr, const int* xi, const int* xic,
                           const int* yi, const float* yfc, const int* x0s,
                           const int* y0s, uint8_t* out, int B, int H, int W,
                           int OH, int OW, int TH, int TW, int WH, int WW,
                           int smem_bytes, void* stream) {
  if (TH <= 0 || TH % WARPS != 0 || TH > THREADS || TW < CPT ||
      TW > TW_MAX || (TW & (TW - 1)) != 0 || WH <= 0 || WW <= 0 ||
      smem_bytes != smem_needed(TH, TW, WH, WW) || smem_bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;   // not a plan of pre_pass_plan
  // persistent blocks: as many as fit the card at once, at most one a tile
  int slots = 0;
  const int err = pre_pass_resident_blocks(smem_bytes, &slots);
  if (err != (int)cudaSuccess) return err;
  const long long tiles = (long long)((OW + TW - 1) / TW) *
                          ((OH + TH - 1) / TH) * B;
  const int grid = (int)min(tiles, (long long)max(slots, 1));
  pre_pass_kernel<<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      bgr, reinterpret_cast<const int4*>(xi), reinterpret_cast<const int4*>(xic),
      reinterpret_cast<const int4*>(yi), reinterpret_cast<const float4*>(yfc),
      x0s, y0s, out, B, H, W, OH, OW, TH, TW, WH, WW, TH / WARPS);
  return (int)cudaGetLastError();
}
