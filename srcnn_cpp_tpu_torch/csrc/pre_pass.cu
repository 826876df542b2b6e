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
// What bounds it on the H100: bytes.  The arithmetic is a few hundred integer
// ops per output pixel; the device-memory traffic is one read of the
// low-resolution BGR frame and one write of the 3-plane output.
//
// What the design does about it (simple first): one thread per output pixel
// computes all three channels, so each tapped BGR pixel is read once for
// three planes; the 16 taps of neighbouring threads overlap and are served
// from L1/L2, so device memory sees close to one read per input byte.  The
// tap tables are per-geometry int32/f32 arrays built on the host from
// cv_cubic_tables and read as one 16-byte vector per axis.  The gather form
// covers every scale (x1.2, x2.75, ...), where the TPU's phase plans covered
// only source steps S <= 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SHIFT = 14, HALF = 1 << (SHIFT - 1), DELTA = 128 << SHIFT;
constexpr int R2Y = 4899, G2Y = 9617, B2Y = 1868, R2CR = 11682, B2CB = 9241;

__device__ __forceinline__ int clamp_u8(int v) { return min(max(v, 0), 255); }

__global__ void pre_pass_kernel(const uint8_t* __restrict__ bgr,
                                const int4* __restrict__ xi,
                                const int4* __restrict__ xic,
                                const int4* __restrict__ yi,
                                const float4* __restrict__ yfc,
                                uint8_t* __restrict__ out,
                                int H, int W, int OH, int OW) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (ox >= OW || oy >= OH) return;

  const size_t plane = (size_t)H * W;
  const uint8_t* pb = bgr + (size_t)b * 3 * plane;
  const uint8_t* pg = pb + plane;
  const uint8_t* pr = pg + plane;

  const int4 cx4 = xi[ox], wx4 = xic[ox], ry4 = yi[oy];
  const float4 fy4 = yfc[oy];
  const int cx[4] = {cx4.x, cx4.y, cx4.z, cx4.w};
  const int wx[4] = {wx4.x, wx4.y, wx4.z, wx4.w};
  const int ry[4] = {ry4.x, ry4.y, ry4.z, ry4.w};
  const float fy[4] = {fy4.x, fy4.y, fy4.z, fy4.w};

  int hs[3][4];   // horizontal int32 sums per channel and vertical tap
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const size_t ro = (size_t)ry[k] * W;
    int s0 = 0, s1 = 0, s2 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bb = pb[ro + cx[j]], gg = pg[ro + cx[j]], rr = pr[ro + cx[j]];
      const int yv = clamp_u8((bb * B2Y + gg * G2Y + rr * R2Y + HALF) >> SHIFT);
      const int cr = clamp_u8(((rr - yv) * R2CR + DELTA + HALF) >> SHIFT);
      const int cb = clamp_u8(((bb - yv) * B2CB + DELTA + HALF) >> SHIFT);
      s0 += yv * wx[j];
      s1 += cr * wx[j];
      s2 += cb * wx[j];
    }
    hs[0][k] = s0;
    hs[1][k] = s1;
    hs[2][k] = s2;
  }

  const size_t oplane = (size_t)OH * OW;
  uint8_t* o = out + (size_t)b * 3 * oplane + (size_t)oy * OW + ox;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float r = __fmul_rn((float)hs[ch][3], fy[3]);
    r = __fadd_rn(__fmul_rn((float)hs[ch][2], fy[2]), r);
    r = __fadd_rn(__fmul_rn((float)hs[ch][1], fy[1]), r);
    r = __fadd_rn(__fmul_rn((float)hs[ch][0], fy[0]), r);
    o[ch * oplane] = (uint8_t)fminf(fmaxf(rintf(r), 0.f), 255.f);
  }
}

}  // namespace

// bgr: B x 3 x H x W u8, contiguous; xi/xic: OW x 4 int32; yi: OH x 4 int32;
// yfc: OH x 4 float32 (all contiguous, 16-byte aligned); out: B x 3 x OH x OW.
extern "C" int pre_pass_u8(const uint8_t* bgr, const int* xi, const int* xic,
                           const int* yi, const float* yfc, uint8_t* out,
                           int B, int H, int W, int OH, int OW, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((OW + 31) / 32, (OH + 7) / 8, B);
  pre_pass_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      bgr, reinterpret_cast<const int4*>(xi), reinterpret_cast<const int4*>(xic),
      reinterpret_cast<const int4*>(yi), reinterpret_cast<const float4*>(yfc),
      out, H, W, OH, OW);
  return (int)cudaGetLastError();
}
