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
//   rcan_conv3x3_kernel<E, L>  every 64->64 conv and the upsampler, on
//                           tensor cores: vdsr_conv.cu's kernel with RCAN's
//                           epilogues and loaders (conv3x3.cuh): ReLU (an
//                           RCAB's first conv), the pool's partial sums (its
//                           second), the skip add (each group's last conv,
//                           the body conv), the pixel-shuffle store (the
//                           upsampler, as four 64-channel output groups);
//                           channel attention (CA) in the loader of the
//                           conv that reads an RCAB's result: s from the
//                           pool's partial sums (the 64->4->64 MLP,
//                           sigmoid), then x = x_prev + s * t as it stages
//                           the input, x stored for the next RCAB;
//   rcan_tail_kernel        conv 64->3 at the output size, + 255 mean,
//                           clamp, round, planar BGR u8 (SIMT).
// 417 kernels a frame at the published shapes (10 groups of 20 RCABs).
// SwinIR's launcher (swinir.cu) runs two of this file's kernels through
// swinir_head and rcan_tail below: swinir_head_kernel, the head conv at
// SwinIR's width (head_conv, which RCAN's head runs at 64) with the patch
// LayerNorm, and rcan_tail_kernel on its upsampled map.
//
// What bounds it on the H100: the 411 64->64 layers (36,864 MACs and 512
// bytes a pixel each, near the card's ridge; 3xTF32 makes the tensor cores
// the bound).  CA's apply, a pass of its own, reads t and x and writes x,
// 768 bytes a pixel and RCAB, bound by HBM: 0.53 ms an RCAB at 1080p, 16.6
// % of the frame's device time (one H100 at 700 W).  Folded into the next
// conv's loader, with t and x grouped, it adds 0.19 ms to that conv's
// 1.33 (the same card).  The pool is 200 global
// reductions a frame between convs that cannot start before them: the
// conv's epilogue sums its own outputs (each consumer warpgroup its rows,
// in a fixed order, no atomics), so CA's finish reads grid x 2 x 64
// floats, not the map.
//
// Buffers (one call's workspace, ops/cuda_rcan.py::rcan_plan): six input-
// size maps (the head's output, kept for the long skip; two group maps used
// in turn; x, the first conv's output a, the second's t), the upsampled
// map and the pool's partial sums.  t and an RCAB's x are kept grouped by
// 8 channels ([8][H][W][8], conv3x3.cuh), the others NHWC.  A skip is
// never the map its conv writes, and no conv writes a map that it reads:
// an RCAB's x goes to x or to the map its group's last conv writes, in
// turn, so that the last RCAB's goes to x.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3.cuh"

namespace {

using namespace srcnn_hopper;

constexpr int C = CONV3X3_C;
constexpr int HEAD_TAPS = 3 * 9;              // [RGB][ky][kx]
constexpr int EDGE_THREADS = 256;
constexpr int PAIRS = 8;                      // pixel pairs a warp walks
constexpr int EDGE_PX = EDGE_THREADS / 32 * 2 * PAIRS;
constexpr int MAPS = 6;                       // input-size maps

// 255 * MeanShift's RGB mean, in float32 as the authors' MeanShift holds it
__device__ __forceinline__ float rgb_mean(int c) {
  return __fmul_rn(255.f, c == 0 ? 0.4488f : c == 1 ? 0.4371f : 0.4040f);
}

// The head and the tail walk a block's EDGE_PX consecutive pixels (row-
// major), a warp two at a time: lane l takes pixel l / 16 of the pair and
// feature channels 4 (l % 16) .. + 3, as vdsr_conv.cu's conv1 and conv20.

// conv 3->CO of RGB - 255 mean, zero outside the frame, at pixel p: the
// CO / 4 channel quads of the half-warp's 16 lanes, lane g holding quads
// g, g + 16, ... (RCAN: CO 64, one quad a lane; SwinIR: CO 184, up to
// three).  bgr: 3 u8 planes of H x W, B first; ws: [27 taps][CO / 4]
// float4 in shared memory; b: the CO biases.
template <int CO>
__device__ __forceinline__ void head_conv(const uint8_t* __restrict__ bgr,
                                          const float4* ws,
                                          const float* __restrict__ b,
                                          long long p, long long px, int H,
                                          int W, int g,
                                          float4 (&a)[(CO / 4 + 15) / 16]) {
  constexpr int Q = CO / 4, K = (Q + 15) / 16;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (g + 16 * k < Q)
      a[k] = __ldg(reinterpret_cast<const float4*>(b) + g + 16 * k);
  const int py = (int)(p / W), pxl = (int)(p - (long long)py * W);
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) {
    const uint8_t* plane = bgr + (size_t)(2 - ci) * px;   // R is plane 2
    const float m = rgb_mean(ci);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int gy = py + t / 3 - 1, gx = pxl + t % 3 - 1;
      const float x = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                          ? __fsub_rn((float)__ldg(plane + (size_t)gy * W +
                                                   gx), m)
                          : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (g + 16 * k >= Q) continue;
        const float4 wk = ws[(ci * 9 + t) * Q + g + 16 * k];
        a[k].x = fmaf(wk.x, x, a[k].x);
        a[k].y = fmaf(wk.y, x, a[k].y);
        a[k].z = fmaf(wk.z, x, a[k].z);
        a[k].w = fmaf(wk.w, x, a[k].w);
      }
    }
  }
}

// RCAN's head: conv 3->64 of RGB - 255 mean.  w: [27 taps][64] then 64
// biases.
__global__ void __launch_bounds__(EDGE_THREADS)
rcan_head_kernel(const uint8_t* __restrict__ bgr, const float* __restrict__ w,
                 float* __restrict__ out, int H, int W) {
  __shared__ float4 ws[HEAD_TAPS * C / 4];
  for (int i = threadIdx.x; i < HEAD_TAPS * C / 4; i += blockDim.x)
    ws[i] = __ldg(reinterpret_cast<const float4*>(w) + i);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane & 15;
  const long long px = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * EDGE_PX +
                       (threadIdx.x >> 5) * 2 * PAIRS + (lane >> 4);
  for (int i = 0; i < PAIRS; ++i) {
    const long long p = p0 + 2 * i;
    if (p >= px) break;
    float4 a[1];
    head_conv<C>(bgr, ws, w + HEAD_TAPS * C, p, px, H, W, g, a);
    *reinterpret_cast<float4*>(out + p * C + 4 * g) = a[0];
  }
}

// SwinIR's head: conv_first 3->180 of RGB / 255 - mean, as conv 3->180 of
// RGB - 255 mean with the weights over 255, into f0 ([H][W][184], the pad
// channels zero), the patch LayerNorm of f0 into normed (eps 1e-5, over
// the 180 channels, two passes), and normed's own statistics (mean, 1 /
// sqrt(var + eps)) into stats, for the first STL's LN1.  w: [27 taps][184],
// 184 biases, 184 gains, 184 biases of the LayerNorm (zero at the pads).
constexpr int SW_CP = 184, SW_DIM = 180, SW_Q = SW_CP / 4;

// LayerNorm's statistics (mean, 1 / sqrt(var + eps), eps 1e-5, over the
// 180 channels, two passes) of the token whose quads the half-warp's 16
// lanes hold in a (the pads zero, and left out of the squares).
__device__ __forceinline__ float2 half_warp_stats(const float4 (&a)[3],
                                                  int g) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (g + 16 * k < SW_Q) s += a[k].x + a[k].y + a[k].z + a[k].w;
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, m);
  const float mean = s / SW_DIM;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (4 * (g + 16 * k) >= SW_DIM) continue;
    const float dx = a[k].x - mean, dy = a[k].y - mean, dz = a[k].z - mean,
                dw = a[k].w - mean;
    q += dx * dx + dy * dy + dz * dz + dw * dw;
  }
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) q += __shfl_xor_sync(0xFFFFFFFFu, q, m);
  return make_float2(mean, 1.f / sqrtf(q / SW_DIM + 1e-5f));
}

__global__ void __launch_bounds__(EDGE_THREADS)
swinir_head_kernel(const uint8_t* __restrict__ bgr,
                   const float* __restrict__ w, float* __restrict__ f0,
                   float* __restrict__ normed, float2* __restrict__ stats,
                   int H, int W) {
  __shared__ float4 ws[HEAD_TAPS * SW_Q];
  for (int i = threadIdx.x; i < HEAD_TAPS * SW_Q; i += blockDim.x)
    ws[i] = __ldg(reinterpret_cast<const float4*>(w) + i);
  __syncthreads();
  const float* bias = w + HEAD_TAPS * SW_CP;
  const float4* gain = reinterpret_cast<const float4*>(bias + SW_CP);
  const float4* shift = gain + SW_Q;
  const int lane = threadIdx.x & 31, g = lane & 15;
  constexpr int K = (SW_Q + 15) / 16;
  const long long px = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * EDGE_PX +
                       (threadIdx.x >> 5) * 2 * PAIRS + (lane >> 4);
  for (int i = 0; i < PAIRS; ++i) {
    const long long p = p0 + 2 * i;
    if (p - (lane >> 4) >= px) break;       // the pair's first pixel
    const bool ok = p < px;
    float4 a[K] = {};
    if (ok) head_conv<SW_CP>(bgr, ws, bias, p, px, H, W, g, a);
    if (ok) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (g + 16 * k < SW_Q)
          reinterpret_cast<float4*>(f0 + p * SW_CP)[g + 16 * k] = a[k];
    }
    // the patch LayerNorm, then normed's statistics for LN1
    float2 st = half_warp_stats(a, g);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c4 = g + 16 * k;
      if (c4 >= SW_Q) continue;
      const float4 gm = __ldg(gain + c4), bt = __ldg(shift + c4);
      a[k] = make_float4((a[k].x - st.x) * st.y * gm.x + bt.x,
                         (a[k].y - st.x) * st.y * gm.y + bt.y,
                         (a[k].z - st.x) * st.y * gm.z + bt.z,
                         (a[k].w - st.x) * st.y * gm.w + bt.w);
    }
    st = half_warp_stats(a, g);
    if (!ok) continue;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (g + 16 * k < SW_Q)
        reinterpret_cast<float4*>(normed + p * SW_CP)[g + 16 * k] = a[k];
    if (g == 0) stats[p] = st;
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

int edge_blocks(long long px) { return (int)((px + EDGE_PX - 1) / EDGE_PX); }

}  // namespace

namespace srcnn_hopper {

// SwinIR's launcher (swinir.cu) runs these two: its head, and RCAN's tail
// on its upsampled map.
cudaError_t swinir_head(const uint8_t* bgr, const float* w, float* f0,
                        float* normed, float2* stats, int H, int W,
                        cudaStream_t s) {
  swinir_head_kernel<<<edge_blocks((long long)H * W), EDGE_THREADS, 0, s>>>(
      bgr, w, f0, normed, stats, H, W);
  return cudaGetLastError();
}

cudaError_t rcan_tail(const float* hr, const float* w, uint8_t* out, int H,
                      int W, cudaStream_t s) {
  rcan_tail_kernel<<<edge_blocks((long long)H * W), EDGE_THREADS, 0, s>>>(
      hr, w, out, H, W);
  return cudaGetLastError();
}

}  // namespace srcnn_hopper

// bgr: B frames of 3 u8 planes (B, G, R) of H x W, frame b at bgr + b *
// frame_stride; out: B x 3 x 2H x 2W u8, planar BGR.  w_head: [27][64] +
// 64 biases; w_mid: the packed 64->64 layers (CONV3X3_LAYER_FLOATS each,
// 16-byte aligned) in the order of ops/cuda_rcan.py::pack_rcan: for each
// group, each RCAB's two convs, then the group's last conv; the body conv;
// the upsampler's four output groups (dy, dx) = (q / 2, q % 2); w_ca: each
// RCAB's CA_FLOATS; w_tail: TAIL_FLOATS.  ws: the workspace (MAPS maps of
// H x W x 64, one of 2H x 2W x 64, grid * POOL_PARTS * 64 pool floats;
// 16-byte aligned).  (grid, smem_bytes): ops/cuda_vdsr.py::vdsr_plan.
extern "C" int rcan_x2_u8(const uint8_t* bgr, long long frame_stride,
                          const float* w_head, const float* w_mid,
                          const float* w_ca, const float* w_tail, float* ws,
                          uint8_t* out, int B, int H, int W, int groups,
                          int blocks, int grid, int smem_bytes,
                          void* stream) {
  if (smem_bytes != CONV3X3_SMEM_BYTES || grid <= 0 ||
      grid * POOL_PARTS > CA_PARTS_MAX || groups <= 0 || blocks <= 0 ||
      (reinterpret_cast<uintptr_t>(w_mid) & 15) != 0 ||
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
  const int parts = grid * POOL_PARTS;
  const size_t layer = CONV3X3_LAYER_FLOATS;
  const EpiArgs none{nullptr, nullptr, 0, 0};
  const EpiArgs pooled{nullptr, pool, 0, 0};
  const LoadArgs plain{};
  for (int b = 0; b < B; ++b) {
    rcan_head_kernel<<<edge_blocks(px), EDGE_THREADS, 0, s>>>(
        bgr + b * frame_stride, w_head, hm, H, W);
    const float* wl = w_mid;
    const float* wca = w_ca;
    const float* gin = hm;
    for (int g = 0; g < groups; ++g) {
      float* gout = gm[g % 2];
      // RCAB k's result x_k = x_{k-1} + s_k t_k (x_{-1} = gin) is formed by
      // the loader of the conv after it, which stores x_k for k < blocks - 1
      // (grouped by 8 channels, conv3x3.cuh) in xm where blocks - 2 - k is
      // even, else in gout
      const float* xprev = gin;
      for (int k = 0; k < blocks; ++k) {
        if (k == 0) {
          e = rcan_conv3x3(EPI_RELU, LOAD_PLAIN, gin, am, wl, H, W, none,
                           plain, grid, s);
        } else {
          float* x = (blocks - 1 - k) % 2 == 0 ? xm : gout;
          const LoadArgs apply{tm, pool, wca - CA_FLOATS, x, nullptr, parts,
                               (float)px, k > 1};
          e = rcan_conv3x3(EPI_RELU, LOAD_APPLY, xprev, am, wl, H, W, none,
                           apply, grid, s);
          xprev = x;
        }
        if (e != cudaSuccess) return (int)e;
        e = rcan_conv3x3(EPI_POOL, LOAD_PLAIN, am, tm, wl + layer, H, W,
                         pooled, plain, grid, s);
        if (e != cudaSuccess) return (int)e;
        wl += 2 * layer;
        wca += CA_FLOATS;
      }
      const EpiArgs skip{gin, nullptr, 0, 0};
      const LoadArgs last{tm, pool, wca - CA_FLOATS, nullptr, nullptr, parts,
                          (float)px, blocks > 1};
      e = rcan_conv3x3(EPI_SKIP, LOAD_APPLY_LAST, xprev, gout, wl, H, W,
                       skip, last, grid, s);
      if (e != cudaSuccess) return (int)e;
      wl += layer;
      gin = gout;
    }
    const EpiArgs long_skip{hm, nullptr, 0, 0};
    e = rcan_conv3x3(EPI_SKIP, LOAD_PLAIN, gin, xm, wl, H, W, long_skip,
                     plain, grid, s);
    if (e != cudaSuccess) return (int)e;
    wl += layer;
    for (int q = 0; q < 4; ++q) {
      EpiArgs shuffle{nullptr, nullptr, q / 2, q % 2};
      e = rcan_conv3x3(EPI_SHUFFLE, LOAD_PLAIN, xm, hr, wl, H, W, shuffle,
                       plain, grid, s);
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

// One 64->64 layer with epilogue `epi` and loader `load` (conv3x3.cuh) on
// an H x W NHWC map, for the tests on the card: in -> out, with skip
// (EPI_SKIP), pool (EPI_POOL: grid * POOL_PARTS * 64 floats) or (dy, dx)
// (EPI_SHUFFLE: out is 2H x 2W x 64); the loaders LOAD_APPLY* form in + s t
// from t, the `parts` x 64 pool sums ca_pool and the CA weights ca, s over
// the H x W pixels, and write s (64 floats) where s is not null (in is
// grouped where in_grouped); LOAD_APPLY stores in + s t to x, grouped.
// RCAN's instances only.
extern "C" int rcan_conv3x3_f32(int epi, int load, const float* in,
                                float* out, const float* wl,
                                const float* skip, float* pool,
                                const float* t, const float* ca_pool,
                                const float* ca, float* x, float* s,
                                int parts, int in_grouped, int dy, int dx,
                                int H, int W, int grid, int smem_bytes,
                                void* stream) {
  if (smem_bytes != CONV3X3_SMEM_BYTES || grid <= 0 || epi < EPI_RELU ||
      epi > EPI_SHUFFLE || load < LOAD_PLAIN ||
      load > LOAD_APPLY_LAST || (reinterpret_cast<uintptr_t>(wl) & 15) != 0 ||
      4LL * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int err = rcan_conv3x3_prepare();
  if (err != 0) return err;
  return (int)rcan_conv3x3(
      (Epilogue)epi, (Loader)load, in, out, wl, H, W,
      EpiArgs{skip, pool, dy, dx},
      LoadArgs{t, ca_pool, ca, x, s, parts, (float)((long long)H * W),
               in_grouped},
      grid, (cudaStream_t)stream);
}
