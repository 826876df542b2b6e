// K1, K4, K5: the fused SRCNN 9-5-5 conv stack, one kernel template over its
// store (the epilogue).
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
// The conv1+conv2 loop and the conv3 accumulation exist once, so the three
// sum in the same order: quantized K5 equals K1, and K4 equals K1 -> K3,
// bit for bit.
//
// What it computes, per output pixel (reference src/srcnn.cpp:189-325):
//   f1 = ReLU(conv1 9x9 1->64 (input replicate-padded by 4) + b1)
//   f2 = ReLU(conv2 1x1 64->32 (f1) + b2)
//   v  = conv3 5x5 32->1 (f2 replicate-padded by 2 at FEATURE level) + b3
// IntTrim(v) truncates toward zero, then clamps to [0, 255] before the u8
// cast.
//
// What bounds it on the H100: FP32 issue.  ~8,000 MACs per output pixel
// (5,184 + 2,048 + 800) against 1 byte in and 1 to 4 bytes out, so memory
// traffic is negligible and the FFMA pipe is the roof.
//
// What the design does about it (simple first; tensor cores come later):
// * one block per (TH x TW) output tile and frame, grid (ceil(W/TW),
//   ceil(H/TH), B);
// * the block stages the packed weights and the (TH+12) x (TW+12) input
//   window (read at clamped coordinates: the input-level clamp) in shared
//   memory, then computes f2 over the (TH+4) x (TW+4) halo at feature
//   coordinates clamped to the image on BOTH axes.  That is exactly the
//   reference's conv3 feature clamp, so no edge fix-up pass exists;
// * each thread owns one f2 position at a time: its 81 conv1 inputs live in
//   registers, every weight is a warp-uniform (broadcast) float4 read from
//   shared memory, and conv1's channel c feeds conv2's 32 accumulators as
//   soon as it is ReLU'd, so f1 never leaves registers;
// * f2 (32 channels x halo) sits in shared memory for conv3; the store
//   writes the result of each pixel directly.  FMA contraction is allowed:
//   the bar is <=1 LSB against the fp32 F.conv2d path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"

namespace {

constexpr int TH = 12, TW = 28;             // output tile
constexpr int HH = TH + 4, HW = TW + 4;     // f2 halo tile (16 x 32)
constexpr int IH = TH + 12, IW = TW + 12;   // input window (24 x 40)
constexpr int NPOS = HH * HW;               // 512 f2 positions
constexpr int NTHREADS = 256;
constexpr int C1 = 64, C2 = 32, K1P = 84;   // conv1 taps 81, padded to 84

// packed weight layout (floats); must match ops/cuda_srcnn.py::pack_weights
constexpr int W1_OFF = 0;                   // [64][84]  w1[c][ky*9+kx]
constexpr int B1_OFF = W1_OFF + C1 * K1P;   // [64]
constexpr int W2_OFF = B1_OFF + C1;         // [64][32]  w2[o][c] stored [c][o]
constexpr int B2_OFF = W2_OFF + C1 * C2;    // [32]
constexpr int W3_OFF = B2_OFF + C2;         // [32][25]  w3[ch][dy*5+dx]
constexpr int B3_OFF = W3_OFF + C2 * 25;    // [1], padded to 4
constexpr int WTOTAL = B3_OFF + 4;
static_assert(WTOTAL == 8324, "packed weight size");
static_assert(WTOTAL % 4 == 0 && W2_OFF % 4 == 0 && (IH * IW) % 4 == 0,
              "float4 alignment of the shared-memory regions");

constexpr size_t SMEM_BYTES = sizeof(float) * (WTOTAL + IH * IW + C2 * NPOS);

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

template <class Store>
__global__ void __launch_bounds__(NTHREADS)
srcnn_conv_kernel(const uint8_t* __restrict__ y, long long frame_stride,
                  const float* __restrict__ wpack, int H, int W,
                  Store store) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // packed weights
  float* win = ws + WTOTAL;                      // input window
  float* f2s = win + IH * IW;                    // f2 halo, [ch][NPOS]

  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH, b = blockIdx.z;
  const uint8_t* src = y + (size_t)b * frame_stride;

  const float4* wp4 = reinterpret_cast<const float4*>(wpack);
  for (int i = tid; i < WTOTAL / 4; i += NTHREADS) smem4[i] = wp4[i];
  for (int i = tid; i < IH * IW; i += NTHREADS) {
    const int r = i / IW, c = i - r * IW;
    const int gy = min(max(oy0 - 6 + r, 0), H - 1);
    const int gx = min(max(ox0 - 6 + c, 0), W - 1);
    win[i] = (float)src[(size_t)gy * W + gx];
  }
  __syncthreads();

  // conv1 + conv2 at every f2 halo position.  Halo position (i, j) holds
  // f2 at feature coordinate (clamp(oy0-2+i), clamp(ox0-2+j)); its conv1
  // window starts at window row/col clamp(...) - (oy0|ox0) + 2.
  for (int p = tid; p < NPOS; p += NTHREADS) {
    const int i = p / HW, j = p - i * HW;
    const int wr = min(max(oy0 - 2 + i, 0), H - 1) - oy0 + 2;
    const int wc = min(max(ox0 - 2 + j, 0), W - 1) - ox0 + 2;
    float x[81];
#pragma unroll
    for (int ky = 0; ky < 9; ++ky)
#pragma unroll
      for (int kx = 0; kx < 9; ++kx) x[ky * 9 + kx] = win[(wr + ky) * IW + wc + kx];

    float f2[C2];
#pragma unroll
    for (int o = 0; o < C2; ++o) f2[o] = ws[B2_OFF + o];

#pragma unroll 1
    for (int c = 0; c < C1; ++c) {
      const float* w1 = ws + W1_OFF + c * K1P;
      const float4* w14 = reinterpret_cast<const float4*>(w1);
      float a = ws[B1_OFF + c];
#pragma unroll
      for (int q = 0; q < 20; ++q) {
        const float4 w = w14[q];
        a = fmaf(w.x, x[4 * q + 0], a);
        a = fmaf(w.y, x[4 * q + 1], a);
        a = fmaf(w.z, x[4 * q + 2], a);
        a = fmaf(w.w, x[4 * q + 3], a);
      }
      a = fmaf(w1[80], x[80], a);
      a = fmaxf(a, 0.f);
      const float4* w24 = reinterpret_cast<const float4*>(ws + W2_OFF + c * C2);
#pragma unroll
      for (int q = 0; q < C2 / 4; ++q) {
        const float4 w = w24[q];
        f2[4 * q + 0] = fmaf(w.x, a, f2[4 * q + 0]);
        f2[4 * q + 1] = fmaf(w.y, a, f2[4 * q + 1]);
        f2[4 * q + 2] = fmaf(w.z, a, f2[4 * q + 2]);
        f2[4 * q + 3] = fmaf(w.w, a, f2[4 * q + 3]);
      }
    }
#pragma unroll
    for (int o = 0; o < C2; ++o) f2s[o * NPOS + p] = fmaxf(f2[o], 0.f);
  }
  __syncthreads();

  // conv3 + b3 on the tile's own pixels, then the store
  for (int q = tid; q < TH * TW; q += NTHREADS) {
    const int r = q / TW, c = q - r * TW;
    const int oy = oy0 + r, ox = ox0 + c;
    if (oy >= H || ox >= W) continue;
    float acc = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < C2; ++ch) {
      const float* f = f2s + ch * NPOS + r * HW + c;
      const float* w3 = ws + W3_OFF + ch * 25;
#pragma unroll
      for (int dy = 0; dy < 5; ++dy)
#pragma unroll
        for (int dx = 0; dx < 5; ++dx) acc = fmaf(w3[dy * 5 + dx], f[dy * HW + dx], acc);
    }
    store(b, oy, ox, H, W, acc + ws[B3_OFF]);
  }
}

template <class Store>
int launch(const uint8_t* y, long long frame_stride, const float* wpack,
           int B, int H, int W, Store store, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      srcnn_conv_kernel<Store>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  srcnn_conv_kernel<Store><<<grid, NTHREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(y, frame_stride, wpack,
                                                     H, W, store);
  return (int)cudaGetLastError();
}

}  // namespace

// y: B planes of H x W u8, plane b at y + b * frame_stride (rows contiguous);
// wpack: WTOTAL floats on the device, 16-byte aligned; out: B x H x W.
extern "C" int srcnn_conv_u8(const uint8_t* y, long long frame_stride,
                             const float* wpack, uint8_t* out,
                             int B, int H, int W, void* stream) {
  return launch(y, frame_stride, wpack, B, H, W, StoreU8{out}, stream);
}

extern "C" int srcnn_conv_f32(const uint8_t* y, long long frame_stride,
                              const float* wpack, float* out,
                              int B, int H, int W, void* stream) {
  return launch(y, frame_stride, wpack, B, H, W, StoreF32{out}, stream);
}

// up, out: B x 3 x H x W u8, contiguous; Y is read from up[:, 0].
extern "C" int srcnn_conv_merge_u8(const uint8_t* up, const float* wpack,
                                   uint8_t* out, int B, int H, int W,
                                   void* stream) {
  return launch(up, 3LL * H * W, wpack, B, H, W, StoreBGR{up, out}, stream);
}
