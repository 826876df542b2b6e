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
// written against ~10 integer ops.
//
// What the design does about it (simple first): one pass, one thread per
// pixel, consecutive threads on consecutive bytes of each plane so every
// warp access is one contiguous 32-byte segment; the merged YCrCb image is
// never written to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"

namespace {

__global__ void merge_kernel(const uint8_t* __restrict__ y,
                             const uint8_t* __restrict__ up,
                             uint8_t* __restrict__ out, long long plane) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const long long b = blockIdx.y;
  srcnn_color::store_bgr(y[b * plane + p], up[(b * 3 + 1) * plane + p],
                         up[(b * 3 + 2) * plane + p], out + b * 3 * plane + p,
                         plane);
}

}  // namespace

// y: B x H x W u8, up/out: B x 3 x H x W u8, all contiguous.
extern "C" int merge_ycrcb_bgr_u8(const uint8_t* y, const uint8_t* up,
                                  uint8_t* out, int B, int H, int W,
                                  void* stream) {
  const long long plane = (long long)H * W;
  const int block = 256;
  const dim3 grid((unsigned)((plane + block - 1) / block), B);
  merge_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(y, up, out, plane);
  return (int)cudaGetLastError();
}

extern "C" const char* srcnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
