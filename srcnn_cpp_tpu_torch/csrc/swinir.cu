// SwinIR x2 on RGB frames (Liang et al., ICCVW 2021, arXiv:2108.10257;
// SwinIR-M, classical SR, the pixel-shuffle upsampler): the head conv
// 3->180 with the patch LayerNorm, 6 RSTBs of 6 Swin transformer layers
// (STL) and a 3x3 conv 180->180 with the group skip, the final LayerNorm,
// conv_after_body with the long skip, conv_before_upsample 180->64 with
// LeakyReLU, RCAN's upsampler (conv 64->256, pixel shuffle) and tail (conv
// 64->3, the mean added back, clamped, rounded, planar BGR u8).
//
// Replaces no TPU kernel: the JAX package runs SRCNN only.  Added so that
// the port's main path (pipeline.upscale_planar) serves a transformer SR
// network; ops/cuda_swinir.py wraps it.
//
// Launched frame by frame on frames whose sides are multiples of the
// window, 8 (the wrapper reflect-pads others and crops), activations in
// device memory as token maps [H][W][184] float32: the 180 channels padded
// to 184 (a multiple of wgmma's k8 and n8), the 4 pad channels zero in
// every map (zero weights, biases, LayerNorm gains and biases there keep
// them zero).  Kernels, 194 a frame at the published depth:
//   swinir_head_kernel     (rcan.cu) conv 3->180 of RGB - 255 mean, the
//                          weights over 255, and the patch LayerNorm: f0
//                          and LN(f0);
//   swin_stl_linear_kernel<LOAD, EPI>  an STL's token-wise linears on
//                          tensor cores: LN1 + qkv (LOAD_LN, the LayerNorm
//                          formed in the loader), proj + the residual
//                          (EPI_RESID), LN2 + fc1 + GELU, fc2 + the
//                          residual;
//   swin_stl_attention_kernel  a window and head: q k^T scale + B (+ M),
//                          softmax, . v on the tensor cores in 3xTF32
//                          (mma.sync), the scores in registers;
//                          the cyclic shift is the window's index
//                          arithmetic and the mask its regions' ids;
//   swinir_conv3x3_kernel<NT, LOAD, EPI>  the RSTB convs and
//                          conv_after_body 180->180 with the skip (the
//                          final LayerNorm in conv_after_body's loader),
//                          conv_before_upsample 180->64 with LeakyReLU;
//   rcan_conv3x3_kernel<EPI_SHUFFLE, LOAD_PLAIN>  (vdsr_conv.cu) the
//                          upsampler, as RCAN runs it;
//   rcan_tail_kernel       (rcan.cu) conv_last, the weights times 255.
//
// The linears and convs share one GEMM body (gemm below): D[128 px][NT] +=
// A[128 px][K] . B[K][NT] on wgmma.mma_async.m64nNTk8.f32.tf32.tf32 in
// 3xTF32 (wgmma.cuh::split: lo.hi + hi.lo + hi.hi, fp32 accumulation), one
// unit a block at a time of 128 consecutive pixels (row-major over the
// frame) by NT output channels, two consumer warpgroups of 64 pixels each,
// a producer warpgroup that fills a ring of STAGES stages: a stage is one
// tap and 16 input channels (two k8 steps: 6 products a consumer between
// two barriers), its weights ([2][NT][8], hi and lo, packed by
// ops/cuda_swinir.py::pack_gemm) by one bulk copy, its 128 pixels' inputs
// by plain loads, split and stored as hi and lo planes of [128 px][4 ch].
// A 1-tap linear walks K = 192 (184 read, the rest zero) or 368 in stages
// of 16; a 3x3 conv walks 9 taps of 192, each tap's pixel shifted (zero
// outside the frame).  The
// pixels are wgmma's M (A, from shared memory), so that a consumer holds a
// pixel's NT outputs in the 4 lanes of a quad: the residual epilogue
// takes the LayerNorm statistics of what it writes with two shuffles, and
// the LayerNorm loader of the next GEMM reads them, 8 bytes a pixel.  Unlike the 64->64 body of
// vdsr_conv.cu (output channels as M), whose instances VDSR and RCAN keep.
//
// Buffers (one call's workspace, ops/cuda_swinir.py::swinir_plan), token
// maps of 184 floats a pixel: F (f0, later conv_before_upsample's 64-map),
// G (an RSTB's input, then its output), X (the STLs' residual stream), O
// (the attention's output), and Q, 552 floats a pixel (qkv; then the MLP's
// 368-map; then the upsampled [2H][2W][64] map).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv3x3.cuh"
#include "wgmma.cuh"

namespace srcnn_hopper {
// rcan.cu: SwinIR's head (conv 3->180, the patch LayerNorm, the
// statistics of its output for LN1) and RCAN's tail, enqueued on s
cudaError_t swinir_head(const uint8_t* bgr, const float* w, float* f0,
                        float* normed, float2* stats, int H, int W,
                        cudaStream_t s);
cudaError_t rcan_tail(const float* hr, const float* w, uint8_t* out, int H,
                      int W, cudaStream_t s);
}  // namespace srcnn_hopper

namespace {

using namespace srcnn_hopper;

constexpr int DIM = 180;       // the embedding
constexpr int CP = 184;        // its padded width: a token map's floats
constexpr int HEADS = 6, HD = 30, HDP = 32;
constexpr int WIN = 8, NTOK = WIN * WIN, TABLE = (2 * WIN - 1) * (2 * WIN - 1);
constexpr int HIDP = 368;      // the MLP's 360, padded
constexpr int QKVP = 3 * CP;   // qkv's 540, padded: q, k, v at 0, 180, 360
constexpr int FEAT = 64;
constexpr float LN_EPS = 1e-5f;

enum SwLoad : int { SW_PLAIN = 0, SW_LN = 1 };
enum SwEpi : int { SW_STORE = 0, SW_GELU = 1, SW_RESID = 2, SW_LEAKY = 3 };

// --- the GEMM body ------------------------------------------------------------

constexpr int TM = 128;                     // pixels of a unit
constexpr int KC = 16;                      // input channels of a stage:
                                            // two k8 steps, 6 products a
                                            // consumer between barriers
constexpr int STAGES = 5;
constexpr int NCONS = 2;                    // 64 pixels a consumer
constexpr int NTHREADS = 128 * (NCONS + 1);
constexpr int HALF = TM * 4 + 8;            // a [128 px][4 ch] plane, padded
                                            // 32 bytes on, so that the four
                                            // planes' stores do not collide
constexpr int A_PLANE = KC / 4 * HALF;      // 16 channels, hi or lo
// a token map's stages of 16 channels (184 read, the rest zero) and the
// MLP's (368)
constexpr int KCH = (184 + KC - 1) / KC, KCH_HID = 368 / KC;

template <int NT>
struct Geo {
  static constexpr int B_MAT = NT * KC;     // [2][NT][8], hi or lo
  static constexpr int STAGE = 2 * B_MAT + 2 * A_PLANE;
  static constexpr int BAR = STAGES * STAGE;
  static constexpr size_t SMEM = sizeof(float) * BAR + 8 * 2 * STAGES;
  static_assert((B_MAT * 4) % 16 == 0 && (STAGE * 4) % 16 == 0 &&
                    BAR % 2 == 0,
                "bulk copies and descriptors on 16-byte boundaries");
  static_assert(SMEM <= 232448, "one block's shared memory on sm_90");
};
static_assert(Geo<184>::STAGE == 10048 && Geo<64>::STAGE == 6208 &&
                  Geo<184>::SMEM == 201040 && Geo<64>::SMEM == 124240,
              "ops/cuda_swinir.py::gemm_smem_bytes");
static_assert((HALF * 4) % 128 == 32, "planes 8 banks apart");

// One GEMM launch: out[p][n] = EPI(sum_k A[p][k] W[n][k] + bias[n]) for the
// H x W pixels p and the ntiles * NT output channels n.  A's rows are the
// input map's (in, cin_stride floats a pixel; LOAD_LN norms them), taken
// at each tap's offset.
struct Gemm {
  const float* in;
  float* out;
  const float* w;      // packed stages (ops/cuda_swinir.py::pack_gemm)
  const float* bias;   // ntiles * NT
  const float* skip;   // SW_RESID: at out's layout (may be out)
  const float* ln;     // SW_LN: gamma[CP], then beta[CP]
  const float2* stats_in;   // SW_LN: (mean, rstd) of each pixel of in
  float2* stats_out;        // SW_RESID: of each pixel of out, or null
  int H, W;
  int cin_stride;      // floats a pixel of in
  int kchunks;         // stages of 8 channels a tap
  int ntiles;
  int out_stride;      // floats a pixel of out
};

__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// D[64 x 184] += A[64 x 8] . B[8 x 184], both from shared memory.
__device__ __forceinline__ void mma(float (&d)[23][4], uint64_t a,
                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %94, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91}, "
      "%92, %93, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3])
      : "l"(a), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 8] . B[8 x 64], both from shared memory.
__device__ __forceinline__ void mma(float (&d)[8][4], uint64_t a,
                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The producer's activation loads run PF stages ahead of its stores, so
// that the loads of a stage's 128 pixels (first touch: the latency of
// HBM) overlap the splitting and storing of the stages before it.
constexpr int PF = 3;
constexpr int PIX = TM * (KC / 4) / 128;    // pixels a producer thread
                                            // stages (4), a channel quad
                                            // of each

// This thread's pixels of a unit and the next stage it loads: tap `tap`,
// channels 16 q + 4 h ..; base[k], the float offset of pixel k's tap in
// the input map (-1 outside the frame), is kept per tap.
template <int TAPS>
struct Cursor {
  int py[PIX], px[PIX];   // the pixels (py < 0: past the end of the frame)
  long long base[PIX];
  int tap, q;

  __device__ __forceinline__ void at_tap(const Gemm& g) {
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int y = py[k] + (TAPS == 1 ? 0 : tap / 3 - 1);
      const int x = px[k] + (TAPS == 1 ? 0 : tap % 3 - 1);
      base[k] = (py[k] < 0 || y < 0 || y >= g.H || x < 0 || x >= g.W)
                    ? -1
                    : ((long long)y * g.W + x) * g.cin_stride;
    }
  }

  // this stage's float4s (zero outside the frame and past the map's
  // channels), then step on
  __device__ __forceinline__ void load(const Gemm& g, int h,
                                       float4 (&v)[PIX]) {
    const int c = q * KC + 4 * h;
#pragma unroll
    for (int k = 0; k < PIX; ++k)
      v[k] = base[k] >= 0 && c < g.cin_stride
                 ? ldg4(g.in + base[k] + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    if (++q == g.kchunks) {
      q = 0;
      ++tap;
      if (TAPS > 1 && tap < TAPS) at_tap(g);
    }
  }
};

// LayerNorm of one channel quad: (x - mean) rstd gamma + beta; a 3x3
// conv's taps outside the frame (rstd < 0) stay 0 (a 1-tap linear has
// none: its pixels past the frame's end are never stored)
template <int TAPS>
__device__ __forceinline__ float4 layer_norm(float4 x, float2 st, float4 gm,
                                             float4 bt) {
  float4 y = make_float4((x.x - st.x) * st.y * gm.x + bt.x,
                         (x.y - st.x) * st.y * gm.y + bt.y,
                         (x.z - st.x) * st.y * gm.z + bt.z,
                         (x.w - st.x) * st.y * gm.w + bt.w);
  if (TAPS > 1) {
    const float in = st.y > 0.f ? 1.f : 0.f;
    y = make_float4(y.x * in, y.y * in, y.z * in, y.w * in);
  }
  return y;
}

template <int NT, int TAPS, int LOAD>
__device__ __forceinline__ void producer(const Gemm& g, float* smem,
                                         uint64_t* full, uint64_t* empty) {
  using G = Geo<NT>;
  const int tid = threadIdx.x & 127;
  const long long P = (long long)g.H * g.W;
  const int count = (int)((P + TM - 1) / TM) * g.ntiles;
  const int ksteps = TAPS * g.kchunks;
  const int h = tid & 3;                    // channels 4h .. 4h + 3
  int pl[PIX];                              // this thread's pixels
#pragma unroll
  for (int k = 0; k < PIX; ++k) pl[k] = (tid >> 2) + 32 * k;
  uint32_t n = 0;                           // stages filled so far
  for (int u = blockIdx.x; u < count; u += gridDim.x) {
    const int nt = u % g.ntiles;
    const long long px0 = (long long)(u / g.ntiles) * TM;
    Cursor<TAPS> cur;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const long long p = px0 + pl[k];
      cur.py[k] = p < P ? (int)(p / g.W) : -1;
      cur.px[k] = p < P ? (int)(p - (long long)cur.py[k] * g.W) : 0;
    }
    cur.tap = cur.q = 0;
    cur.at_tap(g);
    // LOAD_LN: the statistics of each pixel's tap, which the GEMM (or the
    // head) that wrote the map stored; (0, -1) outside the frame.  Tap 0's
    // are loaded before the first stages' inputs, a later tap's when its
    // first stage is stored.
    float2 st[PIX];
    auto tap_stats = [&](int tap) {
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        if (TAPS == 1) {
          const long long p = px0 + pl[k];
          st[k] = p < P ? __ldg(g.stats_in + p) : make_float2(0.f, 1.f);
        } else {
          const int y = cur.py[k] + tap / 3 - 1, x = cur.px[k] + tap % 3 - 1;
          st[k] = cur.py[k] >= 0 && y >= 0 && y < g.H && x >= 0 && x < g.W
                      ? __ldg(g.stats_in + (long long)y * g.W + x)
                      : make_float2(0.f, -1.f);
        }
      }
    };
    if (LOAD == SW_LN) tap_stats(0);
    const float* wt = g.w + (size_t)nt * TAPS * g.kchunks * 2 * G::B_MAT;
    float4 v[PF][PIX];
#pragma unroll
    for (int j = 0; j < PF; ++j)
      if (j < ksteps) cur.load(g, h, v[j]);
    int tap = 0, q = 0;                     // this stage's tap, channels
    for (int k0 = 0; k0 < ksteps; k0 += PF) {
#pragma unroll
      for (int j = 0; j < PF; ++j) {
        const int ks = k0 + j;
        if (ks >= ksteps) break;
        const int s = n % STAGES;
        if (LOAD == SW_LN && TAPS > 1 && q == 0 && tap > 0) tap_stats(tap);
        bar_wait(&empty[s], pass_parity<STAGES>(n) ^ 1u);
        float* stg = smem + s * G::STAGE;
        if (tid == 0) {
          bar_arrive_tx(&full[s], 2 * G::B_MAT * 4);
          bulk_copy(stg, wt + (size_t)ks * 2 * G::B_MAT, 2 * G::B_MAT * 4,
                    &full[s]);
        }
        float4 x[PIX];
#pragma unroll
        for (int k = 0; k < PIX; ++k) x[k] = v[j][k];
        if (ks + PF < ksteps) cur.load(g, h, v[j]);
        if constexpr (LOAD == SW_LN) {
          // the channels past the map's stay zero
          const int c0 = q * KC + 4 * h;
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 gm = c0 < CP ? ldg4(g.ln + c0) : zero;
          const float4 bt = c0 < CP ? ldg4(g.ln + CP + c0) : zero;
#pragma unroll
          for (int k = 0; k < PIX; ++k)
            x[k] = layer_norm<TAPS>(x[k], st[k], gm, bt);
        }
        if (++q == g.kchunks) {
          q = 0;
          ++tap;
        }
        float* a_hi = stg + 2 * G::B_MAT + h * HALF;
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
          uint4 hi, lo;
          split(x[k].x, hi.x, lo.x);
          split(x[k].y, hi.y, lo.y);
          split(x[k].z, hi.z, lo.z);
          split(x[k].w, hi.w, lo.w);
          *reinterpret_cast<uint4*>(a_hi + pl[k] * 4) = hi;
          *reinterpret_cast<uint4*>(a_hi + A_PLANE + pl[k] * 4) = lo;
        }
        // these generic-proxy stores are read by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(&full[s]);
        ++n;
      }
    }
  }
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// LayerNorm's statistics of the two pixels whose NT (= CP) channels the 4
// lanes of a quad hold in acc (rows r = 0, 1): the mean and 1 / sqrt(var +
// eps) over the DIM real channels, two passes (the pad channels are zero,
// and the squares leave them out).
template <int NT>
__device__ __forceinline__ void quad_stats(const float (&acc)[NT / 8][4],
                                           int t, float (&mean)[2],
                                           float (&rstd)[2]) {
  static_assert(NT == CP, "LayerNorm statistics need a whole token");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) s += acc[j][2 * r] + acc[j][2 * r + 1];
    s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
    s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
    mean[r] = s / DIM;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      if (8 * j + 2 * t < DIM) {
        const float d0 = acc[j][2 * r] - mean[r];
        const float d1 = acc[j][2 * r + 1] - mean[r];
        q += d0 * d0 + d1 * d1;
      }
    }
    q += __shfl_xor_sync(0xFFFFFFFFu, q, 1);
    q += __shfl_xor_sync(0xFFFFFFFFu, q, 2);
    rstd[r] = 1.f / sqrtf(q / DIM + LN_EPS);
  }
}

// The epilogue of one consumer's 64 pixels: rows p0 (this thread's g) and
// p0 + 8, columns n0 + 8 j + 2 t, + 1 of D.
template <int NT, int EPI>
__device__ __forceinline__ void epilogue(const Gemm& g, float (&acc)[NT / 8][4],
                                         long long p0, int n0, int t) {
  const long long P = (long long)g.H * g.W;
  const long long p[2] = {p0, p0 + 8};
  const bool ok[2] = {p[0] < P, p[1] < P};
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(
        g.bias + n0 + 8 * j + 2 * t));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v0 = acc[j][2 * r] + b.x, v1 = acc[j][2 * r + 1] + b.y;
      if constexpr (EPI == SW_RESID) {
        if (ok[r]) {
          const float2 s = *reinterpret_cast<const float2*>(
              g.skip + p[r] * g.out_stride + n0 + 8 * j + 2 * t);
          v0 = s.x + v0;
          v1 = s.y + v1;
        }
      }
      if constexpr (EPI == SW_GELU) {
        v0 = gelu(v0);
        v1 = gelu(v1);
      }
      if constexpr (EPI == SW_LEAKY) {
        v0 = v0 > 0.f ? v0 : v0 * 0.01f;
        v1 = v1 > 0.f ? v1 : v1 * 0.01f;
      }
      acc[j][2 * r] = v0;
      acc[j][2 * r + 1] = v1;
    }
  }
  if constexpr (EPI == SW_RESID) {
    // the statistics of the residual stream it writes, for the LayerNorm
    // loader of the GEMM that reads it
    float mean[2], rstd[2];
    quad_stats<NT>(acc, t, mean, rstd);
    if (g.stats_out != nullptr && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (ok[r]) g.stats_out[p[r]] = make_float2(mean[r], rstd[r]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (ok[r])
        *reinterpret_cast<float2*>(g.out + p[r] * g.out_stride + n0 + 8 * j +
                                   2 * t) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int NT, int TAPS, int EPI>
__device__ __forceinline__ void consumer(const Gemm& g, float* smem,
                                         uint64_t* full, uint64_t* empty,
                                         int c) {
  using G = Geo<NT>;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const long long P = (long long)g.H * g.W;
  const int count = (int)((P + TM - 1) / TM) * g.ntiles;
  const int ksteps = TAPS * g.kchunks;
  uint32_t n = 0;                           // stages consumed so far
  for (int u = blockIdx.x; u < count; u += gridDim.x) {
    float acc[NT / 8][4];
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    fence_acc(acc);
    int prev = 0;
    for (int k = 0; k < ksteps; ++k, ++n) {
      const int s = n % STAGES;
      bar_wait(&full[s], pass_parity<STAGES>(n));
      const float* st = smem + s * G::STAGE;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        // k8 step kk: the weights' [NT][8] core matrices, the pixels'
        // planes 2 kk and 2 kk + 1
        const uint64_t b_hi = smem_desc(st + kk * NT * 8, 128, 256);
        const uint64_t b_lo = b_hi + (G::B_MAT * 4 >> 4);
        const uint64_t a_hi = smem_desc(
            st + 2 * G::B_MAT + 2 * kk * HALF + c * 64 * 4, HALF * 4, 128);
        const uint64_t a_lo = a_hi + (A_PLANE * 4 >> 4);
        mma(acc, a_lo, b_hi);
        mma(acc, a_hi, b_lo);
        mma(acc, a_hi, b_hi);
      }
      wg_commit();
      if (k > 0) {
        wg_wait<1>();           // the previous stage's products are done
        bar_arrive(&empty[prev]);
      }
      prev = s;
    }
    wg_wait<0>();
    fence_acc(acc);
    bar_arrive(&empty[prev]);
    const long long px0 = (long long)(u / g.ntiles) * TM;
    epilogue<NT, EPI>(g, acc, px0 + 64 * c + 16 * warp + (lane >> 2),
                      (u % g.ntiles) * NT, lane & 3);
  }
}

template <int NT, int TAPS, int LOAD, int EPI>
__device__ __forceinline__ void gemm(const Gemm& g) {
  using G = Geo<NT>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 128 + 1);         // producer threads + the tx arrival
      bar_init(&empty[s], 128 * NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == NCONS)
    producer<NT, TAPS, LOAD>(g, smem, full, empty);
  else
    consumer<NT, TAPS, EPI>(g, smem, full, empty, wg);
}

// An STL's token-wise linear: 1 tap, 184 output channels a tile.
template <int LOAD, int EPI>
__global__ void __launch_bounds__(NTHREADS, 1)
swin_stl_linear_kernel(Gemm g) {
  gemm<CP, 1, LOAD, EPI>(g);
}

// A 3x3 conv outside the STLs: NT output channels a tile.
template <int NT, int LOAD, int EPI>
__global__ void __launch_bounds__(NTHREADS, 1)
swinir_conv3x3_kernel(Gemm g) {
  gemm<NT, 9, LOAD, EPI>(g);
}

template <int LOAD, int EPI>
cudaError_t linear(const Gemm& g, int grid, cudaStream_t s) {
  swin_stl_linear_kernel<LOAD, EPI><<<grid, NTHREADS, Geo<CP>::SMEM, s>>>(g);
  return cudaGetLastError();
}

template <int NT, int LOAD, int EPI>
cudaError_t conv3x3(const Gemm& g, int grid, cudaStream_t s) {
  swinir_conv3x3_kernel<NT, LOAD, EPI>
      <<<grid, NTHREADS, Geo<NT>::SMEM, s>>>(g);
  return cudaGetLastError();
}

int prepare() {
  const cudaError_t errs[] = {
      cudaFuncSetAttribute(swin_stl_linear_kernel<SW_LN, SW_STORE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Geo<CP>::SMEM),
      cudaFuncSetAttribute(swin_stl_linear_kernel<SW_PLAIN, SW_RESID>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Geo<CP>::SMEM),
      cudaFuncSetAttribute(swin_stl_linear_kernel<SW_LN, SW_GELU>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Geo<CP>::SMEM),
      cudaFuncSetAttribute(swinir_conv3x3_kernel<CP, SW_PLAIN, SW_RESID>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Geo<CP>::SMEM),
      cudaFuncSetAttribute(swinir_conv3x3_kernel<CP, SW_LN, SW_RESID>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Geo<CP>::SMEM),
      cudaFuncSetAttribute(swinir_conv3x3_kernel<FEAT, SW_PLAIN, SW_LEAKY>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Geo<FEAT>::SMEM)};
  for (const cudaError_t err : errs)
    if (err != cudaSuccess) return (int)err;
  return rcan_conv3x3_prepare();
}

// --- window attention ----------------------------------------------------------

constexpr int ATT_WARPS = NTOK / 16;          // 16 queries a warp
constexpr int ATT_THREADS = 32 * ATT_WARPS;
constexpr int RS = HDP + 4;                   // a token's row of q, k, v in
                                              // shared memory, padded so
                                              // that the fragments' loads
                                              // hit 32 banks
constexpr int PS = NTOK + 4;                  // a query's row of p

// D[16 x 8] += A[16 x 8] . B[8 x 8] on the tensor cores in TF32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A . B in 3xTF32 (lo.hi + hi.lo + hi.hi), A split already, B's two
// elements split here.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, l0, l1);
  mma_tf32(d, ah, h0, h1);
}

// A fragment (m16n8k8, tf32) of rows r0 .. r0 + 15, columns c0 .. c0 + 7 of
// a row-major matrix m (row stride rs), split: a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4).
__device__ __forceinline__ void a_frag(const float* m, int rs, int g, int t,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split(m[g * rs + t], ah[0], al[0]);
  split(m[(g + 8) * rs + t], ah[1], al[1]);
  split(m[g * rs + t + 4], ah[2], al[2]);
  split(m[(g + 8) * rs + t + 4], ah[3], al[3]);
}

// One window and head, four warps of 16 queries, on the tensor cores in
// 3xTF32 (mma.sync m16n8k8): S = (q scale) k^T (16 x 64 a warp) + B[rpi(i,
// j)] (+ -100 where the shifted window's regions of i and j differ),
// p = exp(S - the row's max) (a row's 64 scores in the 4 lanes of a quad:
// two shuffles), o = p v / sum(p).  q, k and v are staged in shared memory,
// p passes through it from the accumulator's layout to the operand's.
// The window's tokens are read and written at their place in the frame:
// shifted window token (r, c) (rows and columns of the rolled frame) is
// pixel ((r + shift) mod H, (c + shift) mod W), where roll(-shift) took it
// from and roll(+shift) puts it back.  qkv: [H][W][552], q, k, v of head h
// at h * 30 + {0, 180, 360}; table: [HEADS][225]; out: [H][W][184], head h
// at h * 30 (the last head also zeroes the pad channels).
__global__ void __launch_bounds__(ATT_THREADS)
swin_stl_attention_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ table,
                          float* __restrict__ out, int H, int W, int shift,
                          float scale) {
  __shared__ float qs[NTOK * RS], ks[NTOK * RS], vs[NTOK * RS];
  __shared__ float ps[ATT_WARPS][16 * PS];
  __shared__ float tab[TABLE];
  __shared__ int region[NTOK], pix[NTOK];
  // the 6 heads of a window are neighbouring blocks, so that they meet
  // the window's rows of qkv in L2
  const int head = blockIdx.x % HEADS, wnd = blockIdx.x / HEADS;
  const int nwx = W / WIN, wy = wnd / nwx, wx = wnd % nwx;
  const int tid = threadIdx.x;
  if (tid < NTOK) {
    const int r = wy * WIN + tid / WIN, c = wx * WIN + tid % WIN;
    int y = r + shift, x = c + shift;
    if (y >= H) y -= H;
    if (x >= W) x -= W;
    pix[tid] = y * W + x;
    // the region of the rolled frame (calculate_mask): rows below H - 8
    // are 0, below H - shift 1, the rest 2; columns alike
    const int rh = r < H - WIN ? 0 : r < H - shift ? 1 : 2;
    const int rw = c < W - WIN ? 0 : c < W - shift ? 1 : 2;
    region[tid] = 3 * rh + rw;
#pragma unroll
    for (int d = HD; d < HDP; ++d)
      qs[tid * RS + d] = ks[tid * RS + d] = vs[tid * RS + d] = 0.f;
    if (head == HEADS - 1)
      *reinterpret_cast<float4*>(out + (size_t)pix[tid] * CP + DIM) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int k = tid; k < TABLE; k += ATT_THREADS)
    tab[k] = __ldg(table + head * TABLE + k);
  __syncthreads();
  // the window's q (times the scale, as the authors scale it), k and v:
  // 15 float2 of each a token, a warp's loads along a token's rows, all
  // loaded before the first store
  constexpr int ITEMS = NTOK * 45;
  constexpr int PER = (ITEMS + ATT_THREADS - 1) / ATT_THREADS;
  float2 ld[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * ATT_THREADS;
    if (idx < ITEMS) {
      const int i = idx / 45, rem = idx - i * 45, part = rem / 15;
      ld[k] = __ldg(reinterpret_cast<const float2*>(
          qkv + (size_t)pix[i] * QKVP + part * DIM + head * HD +
          2 * (rem - part * 15)));
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * ATT_THREADS;
    if (idx < ITEMS) {
      const int i = idx / 45, rem = idx - i * 45, part = rem / 15;
      float2 v = ld[k];
      if (part == 0) {
        v.x *= scale;
        v.y *= scale;
      }
      float* dst = (part == 0 ? qs : part == 1 ? ks : vs) + i * RS +
                   2 * (rem - part * 15);
      *reinterpret_cast<float2*>(dst) = v;
    }
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int i0 = 16 * warp + g, i1 = i0 + 8;     // this thread's queries
  uint32_t qh[HDP / 8][4], ql[HDP / 8][4];
#pragma unroll
  for (int kk = 0; kk < HDP / 8; ++kk)
    a_frag(qs + 16 * warp * RS + 8 * kk, RS, g, t, qh[kk], ql[kk]);
  float sc[NTOK / 8][4];
#pragma unroll
  for (int nn = 0; nn < NTOK / 8; ++nn) {
    sc[nn][0] = sc[nn][1] = sc[nn][2] = sc[nn][3] = 0.f;
    const float* kr = ks + (8 * nn + g) * RS + t;
#pragma unroll
    for (int kk = 0; kk < HDP / 8; ++kk)
      mma3(sc[nn], qh[kk], ql[kk], kr[8 * kk], kr[8 * kk + 4]);
  }
  // the bias and the mask, then the softmax of rows i0 (e = 0, 1) and i1
  // (e = 2, 3)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nn = 0; nn < NTOK / 8; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? i0 : i1, j = 8 * nn + 2 * t + (e & 1);
      float a = sc[nn][e] + tab[(i / WIN - j / WIN + WIN - 1) * (2 * WIN - 1) +
                                i % WIN - j % WIN + WIN - 1];
      if (shift && region[i] != region[j]) a += -100.f;
      sc[nn][e] = a;
      mx[e >> 1] = fmaxf(mx[e >> 1], a);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 2));
  }
  float* pw = ps[warp];
#pragma unroll
  for (int nn = 0; nn < NTOK / 8; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[nn][e] = expf(sc[nn][e] - mx[e >> 1]);
      sum[e >> 1] += sc[nn][e];
    }
    *reinterpret_cast<float2*>(pw + g * PS + 8 * nn + 2 * t) =
        make_float2(sc[nn][0], sc[nn][1]);
    *reinterpret_cast<float2*>(pw + (g + 8) * PS + 8 * nn + 2 * t) =
        make_float2(sc[nn][2], sc[nn][3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xFFFFFFFFu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xFFFFFFFFu, sum[r], 2);
  }
  __syncwarp();
  float o[HDP / 8][4];
#pragma unroll
  for (int nd = 0; nd < HDP / 8; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NTOK / 8; ++kk) {
    uint32_t ph[4], pl[4];
    a_frag(pw + 8 * kk, PS, g, t, ph, pl);
    const float* vr = vs + (8 * kk + t) * RS + g;
#pragma unroll
    for (int nd = 0; nd < HDP / 8; ++nd)
      mma3(o[nd], ph, pl, vr[8 * nd], vr[4 * RS + 8 * nd]);
  }
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
  for (int nd = 0; nd < HDP / 8; ++nd) {
    const int d = 8 * nd + 2 * t;
    if (d >= HD) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (size_t)pix[r ? i1 : i0] * CP +
                                 head * HD + d) =
          make_float2(o[nd][2 * r] * inv[r], o[nd][2 * r + 1] * inv[r]);
  }
}

cudaError_t attention(const float* qkv, const float* table, float* out,
                      int H, int W, int shift, float scale, cudaStream_t s) {
  const int grid = (H / WIN) * (W / WIN) * HEADS;
  swin_stl_attention_kernel<<<grid, ATT_THREADS, 0, s>>>(qkv, table, out, H,
                                                         W, shift, scale);
  return cudaGetLastError();
}

// --- the packed weights (floats; ops/cuda_swinir.py::stl_layout) -------------

constexpr int STAGE_W = 2 * CP * KC;                 // a stage: [184][16] x 2
constexpr int QKV_W = 3 * KCH * STAGE_W, QKV_OFF = 0;
constexpr int PROJ_OFF = QKV_OFF + QKV_W + QKVP, PROJ_W = KCH * STAGE_W;
constexpr int FC1_OFF = PROJ_OFF + PROJ_W + CP, FC1_W = 2 * KCH * STAGE_W;
constexpr int FC2_OFF = FC1_OFF + FC1_W + HIDP, FC2_W = KCH_HID * STAGE_W;
constexpr int LN1_OFF = FC2_OFF + FC2_W + CP;
constexpr int LN2_OFF = LN1_OFF + 2 * CP;
constexpr int TAB_OFF = LN2_OFF + 2 * CP;
constexpr int STL_FLOATS = TAB_OFF + HEADS * TABLE + 2;
static_assert(STL_FLOATS == 562736 && TAB_OFF == 561384,
              "ops/cuda_swinir.py::stl_layout");
// convs: the RSTBs' 180->180, the final LayerNorm, conv_after_body, then
// conv_before_upsample 180->64
constexpr int CONV_W = 9 * KCH * STAGE_W, CONV_FLOATS = CONV_W + CP;
constexpr int BEFORE_W = 9 * KCH * 2 * FEAT * KC;
static_assert(CONV_FLOATS % 4 == 0 && STL_FLOATS % 4 == 0,
              "16-byte aligned layers");

Gemm gemm_args(const float* in, float* out, const float* w, int wfloats,
               const float* skip, const float* ln, int H, int W,
               int cin_stride, int kchunks, int ntiles, int out_stride,
               const float2* stats_in = nullptr,
               float2* stats_out = nullptr) {
  return Gemm{in,       out,       w, w + wfloats, skip,       ln,
              stats_in, stats_out, H, W,           cin_stride, kchunks,
              ntiles,   out_stride};
}

}  // namespace

// bgr: B frames of 3 u8 planes (B, G, R) of H x W (multiples of 8), frame b
// at bgr + b * frame_stride; out: B x 3 x 2H x 2W u8, planar BGR.  w_head:
// [27][184] (the weights over 255), 184 biases, the patch LayerNorm's
// gains and biases (184 each); w_stl: groups * depth STLs of STL_FLOATS;
// w_conv: groups RSTB convs and conv_after_body of CONV_FLOATS (the final
// LayerNorm's 2 x 184 after the RSTB convs), then conv_before_upsample;
// w_up: the upsampler's four 64->64 layers (CONV3X3_LAYER_FLOATS each);
// w_tail: RCAN's tail buffer (the weights and biases times 255).  ws: the
// workspace, P x (4 x 184 + 552 + 2) floats, P = H x W (16-byte aligned).
// grid: the GEMMs' persistent grid; up_grid, up_smem: the upsampler's plan
// (ops/cuda_vdsr.py::vdsr_plan).  scale: 30 ** -0.5 in float32.
extern "C" int swinir_x2_u8(const uint8_t* bgr, long long frame_stride,
                            const float* w_head, const float* w_stl,
                            const float* w_conv, const float* w_up,
                            const float* w_tail, float* ws, uint8_t* out,
                            int B, int H, int W, int groups, int depth,
                            int grid, int up_grid, int up_smem, float scale,
                            void* stream) {
  if (H % WIN != 0 || W % WIN != 0 || H <= 0 || W <= 0 || groups <= 0 ||
      depth <= 0 || grid <= 0 || up_grid <= 0 ||
      up_smem != CONV3X3_SMEM_BYTES ||
      (reinterpret_cast<uintptr_t>(w_stl) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(w_conv) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(w_up) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(ws) & 15) != 0 ||
      4LL * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;   // a plan for another kernel
  int err = prepare();
  if (err != 0) return err;
  cudaError_t e = cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const long long P = (long long)H * W;
  const size_t map = (size_t)P * CP;
  float* F = ws;
  float* G = ws + map;
  float* X = ws + 2 * map;
  float* O = ws + 3 * map;
  float* Q = ws + 4 * map;          // qkv, then the MLP's map, then hr
  // LayerNorm's statistics of the map the next LN loader reads: G's (the
  // head's, an RSTB conv's), then X's (proj's, fc2's)
  float2* S = reinterpret_cast<float2*>(Q + (size_t)P * QKVP);
  const float* norm = w_conv + (size_t)groups * CONV_FLOATS;
  const float* after_body = norm + 2 * CP;
  const float* before_up = after_body + CONV_FLOATS;
  for (int b = 0; b < B; ++b) {
    e = swinir_head(bgr + b * frame_stride, w_head, F, G, S, H, W, s);
    if (e != cudaSuccess) return (int)e;
    for (int r = 0; r < groups; ++r) {
      for (int i = 0; i < depth; ++i) {
        const float* wl = w_stl + (size_t)(r * depth + i) * STL_FLOATS;
        const float* x = i == 0 ? G : X;
        e = linear<SW_LN, SW_STORE>(
            gemm_args(x, Q, wl + QKV_OFF, QKV_W, nullptr, wl + LN1_OFF, H,
                      W, CP, KCH, 3, QKVP, S), grid, s);
        if (e != cudaSuccess) return (int)e;
        e = attention(Q, wl + TAB_OFF, O, H, W, i % 2 ? WIN / 2 : 0, scale,
                      s);
        if (e != cudaSuccess) return (int)e;
        e = linear<SW_PLAIN, SW_RESID>(
            gemm_args(O, X, wl + PROJ_OFF, PROJ_W, x, nullptr, H, W, CP, KCH,
                      1, CP, nullptr, S), grid, s);
        if (e != cudaSuccess) return (int)e;
        e = linear<SW_LN, SW_GELU>(
            gemm_args(X, Q, wl + FC1_OFF, FC1_W, nullptr, wl + LN2_OFF, H, W,
                      CP, KCH, 2, HIDP, S), grid, s);
        if (e != cudaSuccess) return (int)e;
        e = linear<SW_PLAIN, SW_RESID>(
            gemm_args(Q, X, wl + FC2_OFF, FC2_W, X, nullptr, H, W, HIDP,
                      KCH_HID, 1, CP, nullptr, S), grid, s);
        if (e != cudaSuccess) return (int)e;
      }
      e = conv3x3<CP, SW_PLAIN, SW_RESID>(
          gemm_args(X, G, w_conv + (size_t)r * CONV_FLOATS, CONV_W, G,
                    nullptr, H, W, CP, KCH, 1, CP, nullptr, S), grid, s);
      if (e != cudaSuccess) return (int)e;
    }
    // the final LayerNorm in conv_after_body's loader
    e = conv3x3<CP, SW_LN, SW_RESID>(gemm_args(G, X, after_body, CONV_W, F,
                                               norm, H, W, CP, KCH, 1, CP, S),
                                     grid, s);
    if (e != cudaSuccess) return (int)e;
    e = conv3x3<FEAT, SW_PLAIN, SW_LEAKY>(
        gemm_args(X, F, before_up, BEFORE_W, nullptr, nullptr, H, W, CP, KCH,
                  1, FEAT), grid, s);
    if (e != cudaSuccess) return (int)e;
    for (int q = 0; q < 4; ++q) {
      const EpiArgs shuffle{nullptr, nullptr, q / 2, q % 2};
      e = rcan_conv3x3(EPI_SHUFFLE, LOAD_PLAIN, F, Q,
                       w_up + (size_t)q * CONV3X3_LAYER_FLOATS, H, W, shuffle,
                       LoadArgs{}, up_grid, s);
      if (e != cudaSuccess) return (int)e;
    }
    e = rcan_tail(Q, w_tail, out + (size_t)b * 3 * 4 * P, 2 * H, 2 * W, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// One GEMM of the body on the card, for the tests: kind 0 qkv (LN1 in the
// loader, from stats), 1 proj or fc2 (the residual, its statistics into
// stats; in of cin 184 or 368 channels), 2 fc1 (LN2 from stats, GELU), 3 a
// 180->180 conv (the skip, its statistics into stats), 4 conv_after_body
// (the final LayerNorm in the loader, from stats; the skip), 5
// conv_before_upsample (LeakyReLU); and 6, the attention of one layer (w:
// the table, cin the shift).
extern "C" int swinir_gemm_f32(int kind, const float* in, float* out,
                               const float* w, int wfloats,
                               const float* skip, const float* ln,
                               float* stats, int H, int W, int cin, int grid,
                               float scale, void* stream) {
  if (grid <= 0 || (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      4LL * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int err = prepare();
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  float2* st = reinterpret_cast<float2*>(stats);
  switch (kind) {
    case 0:
      return (int)linear<SW_LN, SW_STORE>(
          gemm_args(in, out, w, wfloats, nullptr, ln, H, W, CP, KCH, 3, QKVP,
                    st), grid, s);
    case 1:
      if (cin != CP && cin != HIDP) return (int)cudaErrorInvalidValue;
      return (int)linear<SW_PLAIN, SW_RESID>(
          gemm_args(in, out, w, wfloats, skip, nullptr, H, W, cin,
                    (cin + KC - 1) / KC, 1, CP, nullptr, st), grid, s);
    case 2:
      return (int)linear<SW_LN, SW_GELU>(
          gemm_args(in, out, w, wfloats, nullptr, ln, H, W, CP, KCH, 2, HIDP,
                    st), grid, s);
    case 3:
      return (int)conv3x3<CP, SW_PLAIN, SW_RESID>(
          gemm_args(in, out, w, wfloats, skip, nullptr, H, W, CP, KCH, 1, CP,
                    nullptr, st), grid, s);
    case 4:
      return (int)conv3x3<CP, SW_LN, SW_RESID>(
          gemm_args(in, out, w, wfloats, skip, ln, H, W, CP, KCH, 1, CP, st),
          grid, s);
    case 5:
      return (int)conv3x3<FEAT, SW_PLAIN, SW_LEAKY>(
          gemm_args(in, out, w, wfloats, nullptr, nullptr, H, W, CP, KCH, 1,
                    FEAT), grid, s);
    case 6:
      if (H % WIN != 0 || W % WIN != 0) return (int)cudaErrorInvalidValue;
      return (int)attention(in, w, out, H, W, cin, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
