// OpenCV's uint8 YCrCb -> BGR inverse transform, one pixel, in int32.
//
// Shared by K3 (merge.cu) and K4 (srcnn_conv.cu's merge epilogue), so the
// two restate the same arithmetic as ops/color.py::ycrcb2bgr_u8_planar
// (reference src/srcnn.cpp:657 cvtColor(YCrCb2BGR)): 14-bit fixed-point
// coefficients, round-half-up descaling by an arithmetic shift, then a
// clamp to [0, 255] before the narrowing cast.

#pragma once

#include <stdint.h>

namespace srcnn_color {

constexpr int SHIFT = 14, HALF = 1 << (SHIFT - 1);
constexpr int CR2R = 22987, CR2G = -11698, CB2G = -5636, CB2B = 29049;

__device__ __forceinline__ uint8_t clamp_u8(int v) {
  return (uint8_t)min(max(v, 0), 255);
}

struct Bgr {
  uint8_t b, g, r;
};

// y, cr, cb in [0, 255] -> the pixel's three BGR bytes.
__device__ __forceinline__ Bgr ycrcb_to_bgr(int y, int cr, int cb) {
  cr -= 128;
  cb -= 128;
  return {clamp_u8(y + ((cb * CB2B + HALF) >> SHIFT)),
          clamp_u8(y + ((cb * CB2G + cr * CR2G + HALF) >> SHIFT)),
          clamp_u8(y + ((cr * CR2R + HALF) >> SHIFT))};
}

// y, cr, cb in [0, 255]; writes the three BGR planes at o, o + plane,
// o + 2 * plane.
__device__ __forceinline__ void store_bgr(int y, int cr, int cb, uint8_t* o,
                                          long long plane) {
  const Bgr c = ycrcb_to_bgr(y, cr, cb);
  o[0] = c.b;
  o[plane] = c.g;
  o[2 * plane] = c.r;
}

}  // namespace srcnn_color
