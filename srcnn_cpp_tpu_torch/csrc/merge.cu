// K3: fused post-pass, Y' u8 [B,H,W] + upscaled YCrCb u8 [B,3,H,W] -> BGR u8
// [B,3,H,W].
//
// Replaces the TPU kernel srcnn_cpp_tpu/ops/pallas_merge.py::_kernel
// (launched by _merge_call, called from merge_ycrcb_to_bgr_fused).
//
// What it computes, bit-exact with ycrcb2bgr_u8_planar(stack([Y', Cr, Cb]))
// (reference src/srcnn.cpp:638-639 merge and :657 cvtColor(YCrCb2BGR)):
// OpenCV's 14-bit fixed-point inverse transform in int32 (color.cuh),
// clipped to u8.  The Y channel of the upscaled input is never read.
//
// What bounds it on the H100: bytes.  Per pixel 3 bytes are read and 3
// written against ~15 integer ops; at [4,1080,1920] 49.8 MB, 14.9 us at
// 3.35 TB/s.
//
// What the design does about it: every memory access is 16 bytes wide
// where the six planes of every frame (Y', Cr, Cb, B, G, R) share their
// alignment, that is where H*W % 16 == 0 and the three base pointers are
// congruent mod 16 (every common video size on PyTorch's allocator).  Then
// merge_vec_kernel runs: a work unit is 16 consecutive pixels of one frame,
// one 16-byte load each of Y', Cr and Cb, 16 pixels of arithmetic in
// registers, one 16-byte store into each of B, G and R.  A frame's units
// start at its first 16-byte aligned pixel; the unaligned head (unit 0) and
// the ragged tail run per pixel in the kernel.  A grid-stride loop walks
// the units of all frames with BLOCKS_PER_SM blocks per SM, one resident
// wave.  Elsewhere no two planes share a 16-byte word, and
// merge_pixel_kernel runs one thread per pixel, consecutive threads on
// consecutive bytes of each plane, with a grid that covers every pixel.
// The launch plan is ops/cuda_merge.py::merge_plan, which the launcher
// checks against the constants and pointers below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"

namespace {

constexpr int VEC = 16;            // pixels per work unit
constexpr int BLOCK = 256;         // threads per block
constexpr int BLOCKS_PER_SM = 4;   // resident blocks the register budget allows

// 16 pixels whose six planes are all 16-byte aligned at y, cr, cb, o.
__device__ __forceinline__ void merge16(const uint8_t* y, const uint8_t* cr,
                                        const uint8_t* cb, uint8_t* o,
                                        long long plane) {
  const uint4 yv = __ldg(reinterpret_cast<const uint4*>(y));
  const uint4 rv = __ldg(reinterpret_cast<const uint4*>(cr));
  const uint4 bv = __ldg(reinterpret_cast<const uint4*>(cb));
  const uint32_t yw[4] = {yv.x, yv.y, yv.z, yv.w};
  const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w};
  const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
  uint32_t ob[4], og[4], orr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ob[j] = og[j] = orr[j] = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int sh = 8 * q;
      const srcnn_color::Bgr c = srcnn_color::ycrcb_to_bgr(
          (int)((yw[j] >> sh) & 255u), (int)((rw[j] >> sh) & 255u),
          (int)((bw[j] >> sh) & 255u));
      ob[j] |= (uint32_t)c.b << sh;
      og[j] |= (uint32_t)c.g << sh;
      orr[j] |= (uint32_t)c.r << sh;
    }
  }
  *reinterpret_cast<uint4*>(o) = make_uint4(ob[0], ob[1], ob[2], ob[3]);
  *reinterpret_cast<uint4*>(o + plane) =
      make_uint4(og[0], og[1], og[2], og[3]);
  *reinterpret_cast<uint4*>(o + 2 * plane) =
      make_uint4(orr[0], orr[1], orr[2], orr[3]);
}

// Unit k of frame b: k = 0 the head [0, head), k >= 1 the pixels
// [head + 16 (k - 1), +16) clipped to the plane; head is the count of
// pixels before the first 16-byte aligned one, alike in all six planes.
__global__ void __launch_bounds__(BLOCK, BLOCKS_PER_SM)
merge_vec_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ up,
                 uint8_t* __restrict__ out, long long plane,
                 long long per_frame, long long units, long long head) {
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < units;
       i += (long long)gridDim.x * BLOCK) {
    const long long b = i / per_frame, k = i - b * per_frame;
    const uint8_t* yb = y + b * plane;
    const uint8_t* cr = up + (3 * b + 1) * plane;
    const uint8_t* cb = cr + plane;
    uint8_t* o = out + 3 * b * plane;
    const long long s = k == 0 ? 0 : head + (k - 1) * VEC;
    const long long e = k == 0 ? head : min(s + VEC, plane);
    if (e - s == VEC) {
      merge16(yb + s, cr + s, cb + s, o + s, plane);
    } else {
      for (long long p = s; p < e; ++p)
        srcnn_color::store_bgr(yb[p], cr[p], cb[p], o + p, plane);
    }
  }
}

// Pixel blockIdx.x * BLOCK + threadIdx.x of frame blockIdx.y.
__global__ void __launch_bounds__(BLOCK)
merge_pixel_kernel(const uint8_t* __restrict__ y,
                   const uint8_t* __restrict__ up, uint8_t* __restrict__ out,
                   long long plane) {
  const long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= plane) return;
  const long long b = blockIdx.y;
  srcnn_color::store_bgr(y[b * plane + p], up[(b * 3 + 1) * plane + p],
                         up[(b * 3 + 2) * plane + p], out + b * 3 * plane + p,
                         plane);
}

}  // namespace

// y: B x H x W u8, up/out: B x 3 x H x W u8, all contiguous, any alignment.
// (grid, block, vec, per_frame): ops/cuda_merge.py::merge_plan; vec 16 runs
// merge_vec_kernel on a grid of `grid` blocks, vec 1 merge_pixel_kernel on
// grid x B blocks.
extern "C" int merge_ycrcb_bgr_u8(const uint8_t* y, const uint8_t* up,
                                  uint8_t* out, int B, int H, int W, int grid,
                                  int block, int vec, long long per_frame,
                                  void* stream) {
  const long long plane = (long long)H * W;
  const unsigned a = (unsigned)(uintptr_t)y & 15u;
  const bool shared = plane % VEC == 0 && ((uintptr_t)up & 15u) == a &&
                      ((uintptr_t)out & 15u) == a;
  if (B <= 0 || plane <= 0 || grid <= 0 || block != BLOCK)
    return (int)cudaErrorInvalidValue;
  if (vec == VEC && shared && per_frame == 1 + (plane + VEC - 1) / VEC) {
    const long long head = (long long)((VEC - a) % VEC);
    merge_vec_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        y, up, out, plane, per_frame, per_frame * B,
        head < plane ? head : plane);
  } else if (vec == 1 && !shared && per_frame == plane && B <= 65535 &&
             grid == (plane + BLOCK - 1) / BLOCK) {
    merge_pixel_kernel<<<dim3(grid, B), BLOCK, 0, (cudaStream_t)stream>>>(
        y, up, out, plane);
  } else {
    return (int)cudaErrorInvalidValue;   // not a plan of merge_plan
  }
  return (int)cudaGetLastError();
}

extern "C" const char* srcnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
