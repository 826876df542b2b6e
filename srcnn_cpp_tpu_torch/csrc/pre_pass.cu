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
// What bounds it on the H100: bytes.  One read of the low-resolution BGR
// frame and one write of the 3-plane output; the arithmetic per input pixel
// (one color conversion) and per output pixel (a share of the horizontal
// taps, 4 vertical taps per channel) is a few dozen operations.
//
// What the design does about it: a block owns a tile of output pixels.  Its
// input window comes from the tap tables themselves: rows y0 .. y0+WH-1 and
// columns x0 .. x0+WW-1, where (x0, y0) is the smallest tap of the tile's
// columns and rows and (WW, WH) the largest span over all tiles, all
// planned on the host (ops/cuda_resize.py::pre_pass_plan).  The tables
// clamp, so the replicated border and every scale come for free.  Then:
//   1. each window pixel is read from device memory and converted to YCrCb
//      once, into shared memory;
//   2. the horizontal integer pass runs once per window row and output
//      column, into shared memory;
//   3. the vertical float chain runs once per output pixel and channel.
// A block is BX x BY threads: thread x owns output column x of the tile in
// steps 2 and 3 (its column taps are loaded once), and the BY thread rows
// stride over the window and tile rows, so no index needs a division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SHIFT = 14, HALF = 1 << (SHIFT - 1), DELTA = 128 << SHIFT;
constexpr int R2Y = 4899, G2Y = 9617, B2Y = 1868, R2CR = 11682, B2CB = 9241;
constexpr int BX = 64, BY = 4;   // threads: one column of the tile each,
                                 // BY rows at a time; the tile is <= BX wide

__device__ __forceinline__ int clamp_u8(int v) { return min(max(v, 0), 255); }

__global__ void __launch_bounds__(BX * BY)
pre_pass_kernel(const uint8_t* __restrict__ bgr, const int4* __restrict__ xi,
                const int4* __restrict__ xic, const int4* __restrict__ yi,
                const float4* __restrict__ yfc, const int* __restrict__ x0s,
                const int* __restrict__ y0s, uint8_t* __restrict__ out,
                int H, int W, int OH, int OW, int TH, int TW, int WH,
                int WW) {
  extern __shared__ int4 smem4[];
  int* hs = reinterpret_cast<int*>(smem4);     // [3][WH][TW] horizontal sums
  const int wws = (WW + 3) & ~3;
  uint8_t* ycc = reinterpret_cast<uint8_t*>(hs + 3 * WH * TW);  // [3][WH][wws]

  const int tx = threadIdx.x, ty = threadIdx.y, b = blockIdx.z;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH;
  const int x0 = x0s[blockIdx.x], y0 = y0s[blockIdx.y];
  const int tw = min(TW, OW - ox0), th = min(TH, OH - oy0);
  const int wh = min(WH, H - y0), ww = min(WW, W - x0);
  const size_t plane = (size_t)H * W;
  const uint8_t* pb = bgr + (size_t)b * 3 * plane;

  // 1. the window, converted to YCrCb once per pixel
#pragma unroll 4
  for (int r = ty; r < wh; r += BY) {
    const uint8_t* src = pb + (size_t)(y0 + r) * W + x0;
    for (int c = tx; c < ww; c += BX) {
      const int bb = src[c], gg = src[plane + c], rr = src[2 * plane + c];
      const int yv =
          clamp_u8((bb * B2Y + gg * G2Y + rr * R2Y + HALF) >> SHIFT);
      uint8_t* d = ycc + r * wws + c;
      d[0] = (uint8_t)yv;
      d[WH * wws] =
          (uint8_t)clamp_u8(((rr - yv) * R2CR + DELTA + HALF) >> SHIFT);
      d[2 * WH * wws] =
          (uint8_t)clamp_u8(((bb - yv) * B2CB + DELTA + HALF) >> SHIFT);
    }
  }
  __syncthreads();

  // 2. the horizontal pass, once per window row and output column
  if (tx < tw) {
    const int4 cx4 = xi[ox0 + tx], wx4 = xic[ox0 + tx];
    const int cx[4] = {cx4.x - x0, cx4.y - x0, cx4.z - x0, cx4.w - x0};
    const int wx[4] = {wx4.x, wx4.y, wx4.z, wx4.w};
#pragma unroll 4
    for (int r = ty; r < wh; r += BY) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const uint8_t* row = ycc + (ch * WH + r) * wws;
        int s = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) s += row[cx[j]] * wx[j];
        hs[(ch * WH + r) * TW + tx] = s;
      }
    }
  }
  __syncthreads();

  // 3. the vertical pass, once per output pixel and channel
  if (tx < tw) {
    const size_t oplane = (size_t)OH * OW;
#pragma unroll 4
    for (int r = ty; r < th; r += BY) {
      const int oy = oy0 + r;
      const int4 ry4 = yi[oy];
      const float4 fy4 = yfc[oy];
      const int ry[4] = {ry4.x - y0, ry4.y - y0, ry4.z - y0, ry4.w - y0};
      const float fy[4] = {fy4.x, fy4.y, fy4.z, fy4.w};
      uint8_t* o = out + (size_t)b * 3 * oplane + (size_t)oy * OW + ox0 + tx;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int* col = hs + ch * WH * TW + tx;
        float v = __fmul_rn((float)col[ry[3] * TW], fy[3]);
        v = __fadd_rn(__fmul_rn((float)col[ry[2] * TW], fy[2]), v);
        v = __fadd_rn(__fmul_rn((float)col[ry[1] * TW], fy[1]), v);
        v = __fadd_rn(__fmul_rn((float)col[ry[0] * TW], fy[0]), v);
        o[ch * oplane] = (uint8_t)fminf(fmaxf(rintf(v), 0.f), 255.f);
      }
    }
  }
}

}  // namespace

// bgr: B x 3 x H x W u8, contiguous; xi/xic: OW x 4 int32; yi: OH x 4 int32;
// yfc: OH x 4 float32 (all contiguous, 16-byte aligned); x0s: ceil(OW/TW)
// and y0s: ceil(OH/TH) int32 window origins; out: B x 3 x OH x OW.
// (TH, TW, WH, WW, smem_bytes): ops/cuda_resize.py::pre_pass_plan.
extern "C" int pre_pass_u8(const uint8_t* bgr, const int* xi, const int* xic,
                           const int* yi, const float* yfc, const int* x0s,
                           const int* y0s, uint8_t* out, int B, int H, int W,
                           int OH, int OW, int TH, int TW, int WH, int WW,
                           int smem_bytes, void* stream) {
  if (TH <= 0 || TW <= 0 || TW > BX || WH <= 0 || WW <= 0 ||
      smem_bytes < 3 * WH * TW * 4 + 3 * WH * ((WW + 3) & ~3) ||
      smem_bytes > 48 * 1024)
    return (int)cudaErrorInvalidValue;   // not a plan of pre_pass_plan
  const dim3 grid((OW + TW - 1) / TW, (OH + TH - 1) / TH, B);
  pre_pass_kernel<<<grid, dim3(BX, BY), smem_bytes, (cudaStream_t)stream>>>(
      bgr, reinterpret_cast<const int4*>(xi), reinterpret_cast<const int4*>(xic),
      reinterpret_cast<const int4*>(yi), reinterpret_cast<const float4*>(yfc),
      x0s, y0s, out, H, W, OH, OW, TH, TW, WH, WW);
  return (int)cudaGetLastError();
}
