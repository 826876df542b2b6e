// RCAN x2 on RGB frames (Zhang et al., ECCV 2018, arXiv:1807.02758): the
// mean shift and head conv 3->64, residual groups of RCABs with channel
// attention (CA), the group and long skips, the upsampler (conv 64->256,
// pixel shuffle) and the tail conv 64->3 with the mean added back, clamped
// and rounded.
//
// Replaces no TPU kernel: the JAX package runs SRCNN only.  Added so that
// the port's main path (pipeline.upscale_planar) serves a post-upsampling
// RGB network; ops/cuda_rcan.py wraps it.
//
// Launched frame by frame, layer by layer, activations in device memory as
// NHWC float32 ([H][W][64] at the input size, 531 MB a 1080p frame; the
// upsampled map [2H][2W][64], 2.12 GB):
//   rcan_head_kernel        BGR u8 planes -> RGB - 255 mean -> conv 3->64
//                           (SIMT, fp32 FMA);
//   rcan_conv3x3_kernel<E>  every 64->64 conv and the upsampler, on tensor
//                           cores: vdsr_conv.cu's kernel with RCAN's
//                           epilogues (conv3x3.cuh): ReLU (an RCAB's first
//                           conv), the pool's partial sums (its second),
//                           the skip add (each group's last conv, the body
//                           conv), the pixel-shuffle store (the upsampler,
//                           as four 64-channel output groups);
//   rcan_ca_finish_kernel   the partial sums -> z, the 64->4->64 MLP,
//                           sigmoid -> s (one block of 64 threads);
//   rcan_ca_apply_kernel    x <- x + s * t;
//   rcan_tail_kernel        conv 64->3 at the output size, + 255 mean,
//                           clamp, round, planar BGR u8 (SIMT).
//
// What bounds it on the H100: the 411 64->64 layers (36,864 MACs and 512
// bytes a pixel each, near the card's ridge; 3xTF32 makes the tensor cores
// the bound) and CA's apply, which reads t and x and writes x, 768 bytes a
// pixel and RCAB, bound by HBM.  The pool is 200 global reductions a frame
// between convs that cannot start before them: the conv's epilogue sums
// its own outputs (each consumer warpgroup its rows, in a fixed order, no
// atomics), so the finish reads grid x 2 x 64 floats, not the map.
//
// Buffers (one call's workspace, ops/cuda_rcan.py::rcan_plan): six input-
// size maps (the head's output, kept for the long skip; two group maps used
// in turn; x, the first conv's output a, the second's t), the upsampled
// map, the pool's partial sums and s.  A skip is never the map its conv
// writes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3.cuh"

namespace {

using namespace srcnn_hopper;

constexpr int C = CONV3X3_C;
constexpr int HIDDEN = 4;                     // C / reduction 16
// one RCAB's CA weights (floats): W1 [4][64], b1 [4], W2 [64][4], b2 [64]
constexpr int CA_W1 = 0, CA_B1 = HIDDEN * C, CA_W2 = CA_B1 + HIDDEN,
              CA_B2 = CA_W2 + C * HIDDEN, CA_FLOATS = CA_B2 + C;
constexpr int HEAD_TAPS = 3 * 9;              // [RGB][ky][kx]
constexpr int EDGE_THREADS = 256;
constexpr int PAIRS = 8;                      // pixel pairs a warp walks
constexpr int EDGE_PX = EDGE_THREADS / 32 * 2 * PAIRS;
constexpr int APPLY_THREADS = 256;
constexpr int APPLY_BLOCKS_PER_SM = 8;       // of the conv's grid
constexpr int MAPS = 6;                       // input-size maps
static_assert(CA_FLOATS == 580, "ops/cuda_rcan.py::CA_FLOATS");
static_assert(APPLY_THREADS % 16 == 0, "a thread keeps one channel quad");

// 255 * MeanShift's RGB mean, in float32 as the authors' MeanShift holds it
__device__ __forceinline__ float rgb_mean(int c) {
  return __fmul_rn(255.f, c == 0 ? 0.4488f : c == 1 ? 0.4371f : 0.4040f);
}

// The head and the tail walk a block's EDGE_PX consecutive pixels (row-
// major), a warp two at a time: lane l takes pixel l / 16 of the pair and
// feature channels 4 (l % 16) .. + 3, as vdsr_conv.cu's conv1 and conv20.

// conv 3->64 of RGB - 255 mean, zero outside the frame.  bgr: 3 u8 planes
// of H x W, B first; w: [27 taps][64] then 64 biases.
__global__ void __launch_bounds__(EDGE_THREADS)
rcan_head_kernel(const uint8_t* __restrict__ bgr, const float* __restrict__ w,
                 float* __restrict__ out, int H, int W) {
  __shared__ float4 ws[HEAD_TAPS * C / 4];
  for (int i = threadIdx.x; i < HEAD_TAPS * C / 4; i += blockDim.x)
    ws[i] = __ldg(reinterpret_cast<const float4*>(w) + i);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane & 15;
  const float4 b = __ldg(reinterpret_cast<const float4*>(w + HEAD_TAPS * C) +
                         g);
  const long long px = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * EDGE_PX +
                       (threadIdx.x >> 5) * 2 * PAIRS + (lane >> 4);
  for (int i = 0; i < PAIRS; ++i) {
    const long long p = p0 + 2 * i;
    if (p >= px) break;
    const int py = (int)(p / W), pxl = (int)(p - (long long)py * W);
    float4 a = b;
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      const uint8_t* plane = bgr + (size_t)(2 - ci) * px;   // R is plane 2
      const float m = rgb_mean(ci);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int gy = py + k / 3 - 1, gx = pxl + k % 3 - 1;
        const float x = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                            ? __fsub_rn((float)__ldg(plane + (size_t)gy * W +
                                                     gx), m)
                            : 0.f;
        const float4 wk = ws[(ci * 9 + k) * (C / 4) + g];
        a.x = fmaf(wk.x, x, a.x);
        a.y = fmaf(wk.y, x, a.y);
        a.z = fmaf(wk.z, x, a.z);
        a.w = fmaf(wk.w, x, a.w);
      }
    }
    *reinterpret_cast<float4*>(out + p * C + 4 * g) = a;
  }
}

// conv 64->3 at the output size H x W, + 255 mean, clamp to [0, 255],
// round to nearest even, stored as 3 u8 planes B, G, R.  w: [RGB][9][64],
// then 3 biases.  Each lane sums its 4 channels over the 9 taps for the
// three outputs, then the 16 lanes of a pixel add theirs.
__global__ void __launch_bounds__(EDGE_THREADS)
rcan_tail_kernel(const float* __restrict__ act, const float* __restrict__ w,
                 uint8_t* __restrict__ out, int H, int W) {
  __shared__ float4 ws[3 * 9 * C / 4];
  for (int i = threadIdx.x; i < 3 * 9 * C / 4; i += blockDim.x)
    ws[i] = __ldg(reinterpret_cast<const float4*>(w) + i);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane & 15;
  const long long px = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * EDGE_PX +
                       (threadIdx.x >> 5) * 2 * PAIRS + (lane >> 4);
  for (int i = 0; i < PAIRS; ++i) {
    const long long p = p0 + 2 * i;
    if (p - (lane >> 4) >= px) break;       // the pair's first pixel
    float acc[3] = {0.f, 0.f, 0.f};
    if (p < px) {
      const int py = (int)(p / W), pxl = (int)(p - (long long)py * W);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int gy = py + k / 3 - 1, gx = pxl + k % 3 - 1;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            act + ((size_t)gy * W + gx) * C) + g);
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          const float4 wk = ws[(o * 9 + k) * (C / 4) + g];
          acc[o] = fmaf(v.x, wk.x, acc[o]);
          acc[o] = fmaf(v.y, wk.y, acc[o]);
          acc[o] = fmaf(v.z, wk.z, acc[o]);
          acc[o] = fmaf(v.w, wk.w, acc[o]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 3; ++o)
#pragma unroll
      for (int m = 8; m > 0; m >>= 1)
        acc[o] += __shfl_xor_sync(0xFFFFFFFFu, acc[o], m);
    if (g == 0 && p < px) {
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const float v = __fadd_rn(__fadd_rn(acc[o], __ldg(w + 3 * 9 * C + o)),
                                  rgb_mean(o));
        out[(size_t)(2 - o) * px + p] =
            (uint8_t)rintf(fminf(fmaxf(v, 0.f), 255.f));
      }
    }
  }
}

// CA's finish: z = (the partial sums of `parts` pool slots) / npx, in a
// fixed order; s = sigmoid(W2 relu(W1 z + b1) + b2).  One block of 64.
__global__ void __launch_bounds__(C)
rcan_ca_finish_kernel(const float* __restrict__ pool, int parts, float npx,
                      const float* __restrict__ w, float* __restrict__ s) {
  __shared__ float z[C], hid[HIDDEN];
  const int c = threadIdx.x;
  float sum = 0.f;
#pragma unroll 8
  for (int i = 0; i < parts; ++i) sum += pool[(size_t)i * C + c];
  z[c] = __fdiv_rn(sum, npx);
  __syncthreads();
  if (c < HIDDEN) {
    float h = __ldg(w + CA_B1 + c);
    for (int k = 0; k < C; ++k) h = fmaf(__ldg(w + CA_W1 + c * C + k), z[k], h);
    hid[c] = fmaxf(h, 0.f);
  }
  __syncthreads();
  float v = __ldg(w + CA_B2 + c);
#pragma unroll
  for (int j = 0; j < HIDDEN; ++j)
    v = fmaf(__ldg(w + CA_W2 + c * HIDDEN + j), hid[j], v);
  s[c] = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

// CA's apply: xout = xin + s * t over n4 float4s of an NHWC map (xout may
// be xin: each element is read, then written, by one thread).  The grid's
// stride is a multiple of 16 float4s, so a thread's float4s share one
// quad of channels and one quad of s.
__global__ void __launch_bounds__(APPLY_THREADS)
rcan_ca_apply_kernel(const float* xin, const float* __restrict__ t,
                     const float* __restrict__ s, float* xout,
                     long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4 sv = __ldg(reinterpret_cast<const float4*>(s) + (i & 15));
  for (; i < n4; i += stride) {
    const float4 x = reinterpret_cast<const float4*>(xin)[i];
    const float4 tv = __ldg(reinterpret_cast<const float4*>(t) + i);
    float4 r;
    r.x = __fadd_rn(x.x, __fmul_rn(tv.x, sv.x));
    r.y = __fadd_rn(x.y, __fmul_rn(tv.y, sv.y));
    r.z = __fadd_rn(x.z, __fmul_rn(tv.z, sv.z));
    r.w = __fadd_rn(x.w, __fmul_rn(tv.w, sv.w));
    reinterpret_cast<float4*>(xout)[i] = r;
  }
}

int edge_blocks(long long px) { return (int)((px + EDGE_PX - 1) / EDGE_PX); }

}  // namespace

// bgr: B frames of 3 u8 planes (B, G, R) of H x W, frame b at bgr + b *
// frame_stride; out: B x 3 x 2H x 2W u8, planar BGR.  w_head: [27][64] +
// 64 biases; w_mid: the packed 64->64 layers (CONV3X3_LAYER_FLOATS each,
// 16-byte aligned) in the order of ops/cuda_rcan.py::pack_rcan: for each
// group, each RCAB's two convs, then the group's last conv; the body conv;
// the upsampler's four output groups (dy, dx) = (q / 2, q % 2); w_ca: each
// RCAB's CA_FLOATS; w_tail: TAIL_FLOATS.  ws: the workspace (MAPS maps of
// H x W x 64, one of 2H x 2W x 64, grid * POOL_PARTS * 64 pool floats, 64
// of s; 16-byte aligned).  (grid, smem_bytes): ops/cuda_vdsr.py::vdsr_plan.
extern "C" int rcan_x2_u8(const uint8_t* bgr, long long frame_stride,
                          const float* w_head, const float* w_mid,
                          const float* w_ca, const float* w_tail, float* ws,
                          uint8_t* out, int B, int H, int W, int groups,
                          int blocks, int grid, int smem_bytes,
                          void* stream) {
  if (smem_bytes != CONV3X3_SMEM_BYTES || grid <= 0 || groups <= 0 ||
      blocks <= 0 || (reinterpret_cast<uintptr_t>(w_mid) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(ws) & 15) != 0 ||
      4LL * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;   // a plan for another kernel
  const int err = rcan_conv3x3_prepare();
  if (err != 0) return err;
  cudaError_t e = cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const long long px = (long long)H * W;
  const size_t map = (size_t)px * C;
  float* hm = ws;                      // the head's output (long skip)
  float* gm[2] = {ws + map, ws + 2 * map};
  float* xm = ws + 3 * map;
  float* am = ws + 4 * map;
  float* tm = ws + 5 * map;
  float* hr = ws + MAPS * map;         // 2H x 2W x 64
  float* pool = hr + 4 * map;
  float* sv = pool + (size_t)grid * POOL_PARTS * C;
  const int apply_grid = grid * APPLY_BLOCKS_PER_SM;    // grid: <= 1 an SM
  const size_t layer = CONV3X3_LAYER_FLOATS;
  EpiArgs none{nullptr, nullptr, 0, 0};
  for (int b = 0; b < B; ++b) {
    rcan_head_kernel<<<edge_blocks(px), EDGE_THREADS, 0, s>>>(
        bgr + b * frame_stride, w_head, hm, H, W);
    const float* wl = w_mid;
    const float* wca = w_ca;
    const float* gin = hm;
    for (int g = 0; g < groups; ++g) {
      const float* xin = gin;
      for (int k = 0; k < blocks; ++k) {
        e = rcan_conv3x3(EPI_RELU, xin, am, wl, H, W, none, grid, s);
        if (e != cudaSuccess) return (int)e;
        EpiArgs pooled{nullptr, pool, 0, 0};
        e = rcan_conv3x3(EPI_POOL, am, tm, wl + layer, H, W, pooled, grid, s);
        if (e != cudaSuccess) return (int)e;
        rcan_ca_finish_kernel<<<1, C, 0, s>>>(pool, grid * POOL_PARTS,
                                              (float)px, wca, sv);
        rcan_ca_apply_kernel<<<apply_grid, APPLY_THREADS, 0, s>>>(
            xin, tm, sv, xm, (long long)(map / 4));
        xin = xm;
        wl += 2 * layer;
        wca += CA_FLOATS;
      }
      float* gout = gm[g % 2];
      EpiArgs skip{gin, nullptr, 0, 0};
      e = rcan_conv3x3(EPI_SKIP, xm, gout, wl, H, W, skip, grid, s);
      if (e != cudaSuccess) return (int)e;
      wl += layer;
      gin = gout;
    }
    EpiArgs long_skip{hm, nullptr, 0, 0};
    e = rcan_conv3x3(EPI_SKIP, gin, xm, wl, H, W, long_skip, grid, s);
    if (e != cudaSuccess) return (int)e;
    wl += layer;
    for (int q = 0; q < 4; ++q) {
      EpiArgs shuffle{nullptr, nullptr, q / 2, q % 2};
      e = rcan_conv3x3(EPI_SHUFFLE, xm, hr, wl, H, W, shuffle, grid, s);
      if (e != cudaSuccess) return (int)e;
      wl += layer;
    }
    rcan_tail_kernel<<<edge_blocks(4 * px), EDGE_THREADS, 0, s>>>(
        hr, w_tail, out + (size_t)b * 3 * 4 * px, 2 * H, 2 * W);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// One 64->64 layer with epilogue `epi` (conv3x3.cuh) on an H x W NHWC map,
// for the tests on the card: in -> out, with skip (EPI_SKIP),
// pool (EPI_POOL: grid * POOL_PARTS * 64 floats) or (dy, dx) (EPI_SHUFFLE:
// out is 2H x 2W x 64).
extern "C" int rcan_conv3x3_f32(int epi, const float* in, float* out,
                                const float* wl, const float* skip,
                                float* pool, int dy, int dx, int H, int W,
                                int grid, int smem_bytes, void* stream) {
  if (smem_bytes != CONV3X3_SMEM_BYTES || grid <= 0 || epi < EPI_RELU ||
      epi > EPI_SHUFFLE || (reinterpret_cast<uintptr_t>(wl) & 15) != 0 ||
      4LL * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int err = rcan_conv3x3_prepare();
  if (err != 0) return err;
  return (int)rcan_conv3x3((Epilogue)epi, in, out, wl, H, W,
                           EpiArgs{skip, pool, dy, dx}, grid,
                           (cudaStream_t)stream);
}
