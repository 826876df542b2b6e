// The VDSR chain on Y (Kim, Lee, Lee, CVPR 2016, arXiv:1511.04587): twenty
// zero-padded 3x3 convolutions, ReLU after all but the last, y = x + f(x).
//
// Replaces no TPU kernel: the JAX package runs SRCNN only.  Added so that
// the port's main path (pipeline.upscale_planar: K2 -> the weights' network
// on Y -> K3) serves a second network; ops/cuda_vdsr.py wraps it.
//
// Three kernels, launched layer by layer for each frame, activations in
// device memory as NHWC float32 [H][W][64] (2.12 GB a 4K frame), two
// buffers used in turn:
//   vdsr_first_kernel   conv1 1->64 + ReLU on x = u8 / 255 (SIMT, fp32 FMA);
//   vdsr_conv3x3_kernel conv2..conv19, 64->64 + ReLU, on tensor cores;
//   vdsr_last_kernel    conv20 64->1 on the SIMT units, the residual x + f,
//                       x 255, round to nearest, clamp, the u8 store.
//
// What bounds it on the H100: a 64->64 layer is 36,864 MACs a pixel against
// 512 bytes of activation read and written through HBM, 144 FLOP/B at the
// dense TF32 rate, near the card's ridge of 148; in 3xTF32 (three products
// a MAC) the tensor cores bound it, at 3 x 22.3 ms of products a 4K frame,
// with 76.5 GB a frame of activations (22.9 ms at 3.35 TB/s) to hide.
//
// What the design does about it:
// * each 64->64 layer is a GEMM D[64 co][128 px] += W[64 co][576] .
//   X[576][128 px] per work unit on wgmma.mma_async.m64n128k8.f32.tf32.tf32,
//   both operands from shared memory through matrix descriptors (K-major, no
//   swizzle).  A unit is 2 output rows by 128 output columns, one row per
//   consumer warpgroup; its K (9 taps x 64 input channels) is walked in 8
//   stages of 8 input channels, each stage holding the 4 input rows the two
//   output rows reach (130 columns, zero outside the image) and the 9 taps'
//   weights of those 8 channels;
// * fp32 accuracy from the 3xTF32 split (wgmma.cuh::split): the weights are
//   split on the host (ops/cuda_srcnn.py::tf32_split), the activations by
//   the loader as it stages them, and each product is lo.hi + hi.lo +
//   hi.hi, small terms first, accumulated in fp32 from the bias;
// * a tap is a descriptor offset, not a copy: in a stage, each input row
//   holds per 4 channels a plane of [130 columns][4 channels], so the 8 x 4
//   core matrix of 8 consecutive pixels is 128 contiguous bytes (SBO 128)
//   and the next 4 channels one plane further (LBO); tap (ky, kx) starts
//   at row ky, column kx: 16 bytes a column;
// * warp specialisation, one persistent block per SM: a producer warpgroup
//   fills a ring of 3 stages (the weights by one bulk copy, completing on
//   the stage's mbarrier; the activations by plain loads, split and stored
//   as hi and lo planes), two consumer warpgroups issue a stage's 27
//   products each and free the stage they finished one stage later, so the
//   loads of two stages overlap the products;
// * the 1->64 and 64->1 layers (576 MACs a pixel each) stay off the tensor
//   cores, in fp32 FMA: padding them to an MMA tile would multiply their
//   work, and each is bound by its one pass over an activation.
//
// The plan (grid, shared-memory bytes) is computed by
// ops/cuda_vdsr.py::vdsr_plan and handed to the launcher, which refuses a
// plan that does not match the constants below.
//
// The 64->64 kernel's body is shared with RCAN (rcan.cu): its epilogue and
// its loader are template parameters (conv3x3.cuh).  VDSR's
// vdsr_conv3x3_kernel is the EPI_RELU store on the plain loader; RCAN
// launches rcan_conv3x3_kernel<EPI, LOAD> through rcan_conv3x3 below, for
// its ReLU, pooled, skip-adding and pixel-shuffle layers, and with the
// loader that forms an RCAB's result x = x_prev + s * t (channel attention)
// as it stages the input of the conv that reads it: the producer first
// computes s from the pool sums of the conv that wrote t (ca_finish, while
// the first stage's weights arrive), then reads x_prev and t where the
// plain loader reads its input, 512 bytes a pixel instead of 256, both
// grouped by 8 channels so that a stage's reads are contiguous rows, and
// stores x once, from the unit that owns the pixel.  ptxas fits these
// instances in the block's 168 registers a thread without spilling.
//
// Each instance has a probed twin (PROBE = true, probe.cuh) that counts the
// consumers' waits on `full`, their epilogues and the producer's fills; the
// launchers run it only when given the counter records.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3.cuh"
#include "wgmma.cuh"

namespace {

using namespace srcnn_hopper;

constexpr int DEPTH = 20;                   // layers of the network
constexpr int C = 64;                       // feature maps
constexpr int TN = 128;                     // output columns of a unit
constexpr int ROWS = 2;                     // output rows of a unit
constexpr int NCONS = ROWS;                 // one consumer warpgroup a row
constexpr int IN_ROWS = ROWS + 2;           // input rows a unit reaches
constexpr int COLS = TN + 2;                // input columns a unit reaches
constexpr int NC = TN + 4;                  // column stride of a plane: a
                                            // 4-channel plane 64 banks on,
                                            // so the loader's stores of
                                            // both planes do not collide
constexpr int CG = 8;                       // input channels of a stage
constexpr int CHUNKS = C / CG;              // stages of a unit
constexpr int TAPS = 9;
constexpr int STAGES = 3;
constexpr int NTHREADS = 128 * (NCONS + 1); // + the producer warpgroup

// a stage (floats): the weights, then the activations' hi and lo planes
constexpr int W_MAT = C * CG;               // [64 co][8 ci] core matrices
constexpr int W_STAGE = TAPS * 2 * W_MAT;   // per tap: hi, lo
constexpr int ACT_HALF = NC * 4;            // [NC cols][4 ch]
constexpr int ACT_ROW = 2 * ACT_HALF;       // 8 channels of one input row
constexpr int ACT_PLANE = IN_ROWS * ACT_ROW;
constexpr int STAGE = W_STAGE + 2 * ACT_PLANE;
constexpr int BAR_OFF = STAGES * STAGE;     // mbarriers: full, then empty
constexpr size_t SMEM_BYTES = sizeof(float) * BAR_OFF + 8 * 2 * STAGES;
// packed weights of one 64->64 layer (floats; ops/cuda_vdsr.py::pack_vdsr):
// for each stage q, tap, plane the [64][8] core matrices of channels 8q..,
// then the 64 biases
constexpr int W_LAYER = CHUNKS * W_STAGE;
constexpr int LAYER_FLOATS = W_LAYER + C;
constexpr int W_EDGE = TAPS * C;            // conv1 / conv20: [9][64] taps
static_assert(W_STAGE == 9216 && ACT_PLANE == 4224 && STAGE == 17664,
              "stage layout (ops/cuda_vdsr.py::stage_layout)");
static_assert(SMEM_BYTES == 211968 + 48, "shared memory of the plan");
// LOAD_APPLY*: CA's s (64 floats) after the mbarriers; while s is computed,
// its scratch (z, the hidden layer, the pool sums) in stages 1 and 2
constexpr int S_OFF = BAR_OFF + 2 * STAGES * 2;
constexpr size_t SMEM_APPLY_BYTES = SMEM_BYTES + sizeof(float) * C;
static_assert(sizeof(float) * S_OFF == SMEM_BYTES && S_OFF % 4 == 0,
              "s after the mbarriers, 16-byte aligned");
static_assert(C + CA_HIDDEN + CA_PARTS_MAX * C <= 2 * STAGE &&
              (C + CA_HIDDEN) % 4 == 0, "the pool sums fit stages 1 and 2");
static_assert(SMEM_APPLY_BYTES <= 232448, "one block's shared memory");
static_assert(C == CONV3X3_C && NCONS == POOL_PARTS &&
              LAYER_FLOATS == CONV3X3_LAYER_FLOATS &&
              SMEM_BYTES == CONV3X3_SMEM_BYTES, "conv3x3.cuh");
static_assert(SMEM_BYTES <= 232448, "one block's shared memory on sm_90");
static_assert((NC * 16) % 128 == 64, "planes 16 banks apart");
static_assert((W_STAGE * 4) % 16 == 0 && (LAYER_FLOATS * 4) % 16 == 0,
              "bulk copies of 16-byte multiples from 16-byte boundaries");
constexpr uint32_t W_LBO = 128, W_SBO = 256;        // weight descriptors
constexpr uint32_t X_LBO = ACT_HALF * 4, X_SBO = 128;  // activation ones

// --- bulk copies ---------------------------------------------------------------

// Arrive on b and add `bytes` to the transfers its phase waits for.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}

// Copy `bytes` from global src to shared dst; completes on b's transfers.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// D[64 x 128] += A[64 x 8] . B[8 x 128], both from shared memory.
__device__ __forceinline__ void mma_n128(float (&d)[TN / 8][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
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
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

// Unit u of a frame: output rows y0, y0 + 1 and columns x0 .. x0 + TN - 1,
// clipped to the image; consecutive units walk along a row pair.
struct Units {
  int H, W, sx_n, count;

  __device__ Units(int H_, int W_)
      : H(H_), W(W_), sx_n((W_ + TN - 1) / TN),
        count(((H_ + ROWS - 1) / ROWS) * ((W_ + TN - 1) / TN)) {}

  __device__ int y0(int u) const { return (u / sx_n) * ROWS; }
  __device__ int x0(int u) const { return (u % sx_n) * TN; }
};

// --- producer: the weights and the split activations of each stage ----------

// Named barrier 1 over the producer warpgroup's 128 threads; the fence
// orders their shared-memory accesses before the bulk copies after it.
__device__ __forceinline__ void producer_sync() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// CA's s of a LOAD_APPLY* launch into s (shared memory), by the producer:
// the pool sums staged in `scratch` (stages 1 and 2, which the ring fills
// only after this), then ca_finish, as RCAN's finish computed it.
__device__ __forceinline__ void ca_scale(const LoadArgs& la, float* scratch,
                                         float* s, int tid) {
  float* z = scratch;
  float* hid = z + C;
  float* pool = hid + CA_HIDDEN;
  const float4* src = reinterpret_cast<const float4*>(la.pool);
  float4* dst = reinterpret_cast<float4*>(pool);
  const int n4 = la.parts * (C / 4);
#pragma unroll 4
  for (int i = tid; i < n4; i += 128) dst[i] = __ldg(src + i);
  producer_sync();
  ca_finish(pool, la.parts, la.npx, la.ca, z, hid, s, tid,
            [] { producer_sync(); });
  if (la.s != nullptr && blockIdx.x == 0 && tid < C) la.s[tid] = s[tid];
}

// LOAD_APPLY*'s maps.  x_prev is NHWC (a group's input) or, as this loader
// stores x, in channel groups: [8][H][W][8], group q of every pixel
// contiguous; t too, as the pool epilogue stores it.  A stage then reads
// rows of 130 x 32 contiguous bytes of each, not 32 bytes of every 256:
// with t NHWC the fused loader added 0.39 ms to a 1080p layer, with t
// grouped too 0.19 ms (one H100 at 700 W).  Float offset of the channels
// 8q + 4h .. + 3 of pixel px in each:
__device__ __forceinline__ size_t nhwc(size_t px, int q, int h) {
  return px * C + q * CG + 4 * h;
}
__device__ __forceinline__ size_t grouped(size_t px, size_t npx, int q,
                                          int h) {
  return ((size_t)q * npx + px) * CG + 4 * h;
}

// A read-only load that asks L2 to fetch the 256 bytes around it, which
// the unit reads next: its next pixels (grouped) or channels (NHWC).  It
// took 0.05 ms off a 1080p layer with t and x grouped, 0.11 ms with both
// NHWC (one H100 at 700 W).
__device__ __forceinline__ float4 ldg_l2_256(const float* p) {
  float4 v;
  asm("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

// x + s * t, CA's apply of one channel quad
__device__ __forceinline__ float4 ca_apply(float4 x, float4 t, float4 s) {
  return make_float4(__fadd_rn(x.x, __fmul_rn(t.x, s.x)),
                     __fadd_rn(x.y, __fmul_rn(t.y, s.y)),
                     __fadd_rn(x.z, __fmul_rn(t.z, s.z)),
                     __fadd_rn(x.w, __fmul_rn(t.w, s.w)));
}

template <int LOAD, bool PROBE>
__device__ __forceinline__ void producer(const float* __restrict__ in,
                                         const float* __restrict__ wl,
                                         const Units& un, float* smem,
                                         uint64_t* full, uint64_t* empty,
                                         const LoadArgs& la, Probe* probe) {
  const int tid = threadIdx.x & 127;
  ProducerTally tl;
  if constexpr (PROBE) tl.start();
  constexpr int ITEMS = IN_ROWS * COLS * 2;      // float4s of a stage
  constexpr int PER = (ITEMS + 127) / 128;
  constexpr bool APPLY = LOAD != LOAD_PLAIN;
  if constexpr (APPLY) {
    // the first stage's weights arrive while s is computed
    if (tid == 0 && (int)blockIdx.x < un.count) {
      bar_arrive_tx(&full[0], W_STAGE * 4);
      bulk_copy(smem, wl, W_STAGE * 4, &full[0]);
    }
    ca_scale(la, smem + STAGE, smem + S_OFF, tid);
  }
  const size_t npx = (size_t)un.H * un.W;
  uint32_t n = 0;                                // stages filled so far
  for (int u = blockIdx.x; u < un.count; u += gridDim.x) {
    const int y0 = un.y0(u), x0 = un.x0(u);
    for (int q = 0; q < CHUNKS; ++q, ++n) {
      const int s = n % STAGES;
      if constexpr (PROBE)
        tl.wait_empty(&empty[s], pass_parity<STAGES>(n) ^ 1u);
      else
        bar_wait(&empty[s], pass_parity<STAGES>(n) ^ 1u);
      float* st = smem + s * STAGE;
      if (tid == 0 && (!APPLY || n > 0)) {
        bar_arrive_tx(&full[s], W_STAGE * 4);
        bulk_copy(st, wl + q * W_STAGE, W_STAGE * 4, &full[s]);
      }
      float4 v[PER];
      float4 t[APPLY ? PER : 1];                 // LOAD_APPLY*: t
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = tid + 128 * k;
        const int r = idx >> 1, i = r / COLS;
        const int gy = y0 - 1 + i, gx = x0 - 1 + r % COLS;
        v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (APPLY) t[k] = v[k];     // x = 0 + 0 s outside
        if (idx < ITEMS && gy >= 0 && gy < un.H && gx >= 0 && gx < un.W) {
          if constexpr (APPLY) {
            const size_t px = (size_t)gy * un.W + gx;
            const int h = idx & 1;
            v[k] = ldg_l2_256(in + (la.in_grouped ? grouped(px, npx, q, h)
                                                  : nhwc(px, q, h)));
            t[k] = ldg_l2_256(la.t + grouped(px, npx, q, h));
          } else {
            v[k] = __ldg(reinterpret_cast<const float4*>(
                in + ((size_t)gy * un.W + gx) * C + q * CG + 4 * (idx & 1)));
          }
        }
      }
      // a thread's items all hold channels 8q + 4 (tid & 1) .. + 3
      float4 sv;
      if constexpr (APPLY)
        sv = reinterpret_cast<const float4*>(smem + S_OFF)[2 * q + (tid & 1)];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = tid + 128 * k;
        if (idx < ITEMS) {
          const int r = idx >> 1, i = r / COLS, col = r % COLS;
          if constexpr (APPLY) v[k] = ca_apply(v[k], t[k], sv);
          float* hi = st + W_STAGE + i * ACT_ROW + (idx & 1) * ACT_HALF +
                      col * 4;
          uint4 h, l;
          split(v[k].x, h.x, l.x);
          split(v[k].y, h.y, l.y);
          split(v[k].z, h.z, l.z);
          split(v[k].w, h.w, l.w);
          *reinterpret_cast<uint4*>(hi) = h;
          *reinterpret_cast<uint4*>(hi + ACT_PLANE) = l;
        }
      }
      // these generic-proxy stores are read by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(&full[s]);
      if constexpr (LOAD == LOAD_APPLY) {
        // x of the unit's own pixels (rows y0, y0 + 1, columns x0 .. +
        // 127), grouped; after the arrive, which need not wait for them
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int idx = tid + 128 * k;
          const int r = idx >> 1, i = r / COLS, col = r % COLS;
          const int gy = y0 - 1 + i, gx = x0 - 1 + col;
          if (idx < ITEMS && i >= 1 && i <= ROWS && col >= 1 && col <= TN &&
              gy < un.H && gx < un.W)
            *reinterpret_cast<float4*>(
                la.x + grouped((size_t)gy * un.W + gx, npx, q, idx & 1)) =
                v[k];
        }
      }
    }
  }
  if constexpr (PROBE) tl.flush(probe, n, tid);
}

// --- consumers: one output row of each unit ----------------------------------

template <int EPI, bool PROBE>
__device__ __forceinline__ void consumer(float* __restrict__ out,
                                         const float* __restrict__ bias,
                                         const Units& un, float* smem,
                                         uint64_t* full, uint64_t* empty,
                                         int c, const EpiArgs& ea,
                                         Probe* probe) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  ConsumerTally tl;
  const int g = lane >> 2, t = lane & 3;
  const int co0 = 16 * warp + g;                 // rows co0, co0 + 8 of D
  const float b0 = __ldg(bias + co0), b1 = __ldg(bias + co0 + 8);
  float pool0 = 0.f, pool1 = 0.f;                // EPI_POOL: this row's sums
  uint32_t n = 0;                                // stages consumed so far
  for (int u = blockIdx.x; u < un.count; u += gridDim.x) {
    float acc[TN / 8][4];
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      acc[j][0] = b0; acc[j][1] = b0;
      acc[j][2] = b1; acc[j][3] = b1;
    }
    fence_acc(acc);
    int prev = 0;
    for (int q = 0; q < CHUNKS; ++q, ++n) {
      const int s = n % STAGES;
      if constexpr (PROBE)
        tl.wait_full(&full[s], pass_parity<STAGES>(n), q);
      else
        bar_wait(&full[s], pass_parity<STAGES>(n));
      const float* st = smem + s * STAGE;
      wg_fence();
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const uint64_t a_hi = smem_desc(st + 2 * tap * W_MAT, W_LBO, W_SBO);
        const uint64_t a_lo = a_hi + (W_MAT * 4 >> 4);
        const uint64_t x_hi = smem_desc(
            st + W_STAGE + (c + ky) * ACT_ROW + kx * 4, X_LBO, X_SBO);
        const uint64_t x_lo = x_hi + (ACT_PLANE * 4 >> 4);
        mma_n128(acc, a_lo, x_hi);
        mma_n128(acc, a_hi, x_lo);
        mma_n128(acc, a_hi, x_hi);
      }
      wg_commit();
      if (q > 0) {
        wg_wait<1>();           // the previous stage's products are done
        bar_arrive(&empty[prev]);
      }
      prev = s;
    }
    wg_wait<0>();
    if constexpr (PROBE) tl.epilogue_start();
    fence_acc(acc);
    bar_arrive(&empty[prev]);

    // the epilogue and the store: D row co, column px is pixel (y, x0 + px)
    const int y = un.y0(u) + c, x0 = un.x0(u);
    if (y < un.H) {
      if constexpr (EPI == EPI_RELU) {
        float* row = out + ((size_t)y * un.W + x0) * C;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int px = 8 * j + 2 * t + (e & 1);
            if (x0 + px < un.W)
              row[(size_t)px * C + co0 + 8 * (e >> 1)] =
                  fmaxf(acc[j][e], 0.f);
          }
        }
      } else {
        const bool shuffle = EPI == EPI_SHUFFLE;
        const size_t ow = shuffle ? 2 * (size_t)un.W : un.W;
        const size_t oy = shuffle ? 2 * (size_t)y + ea.dy : y;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int px = 8 * j + 2 * t + (e & 1);
            if (x0 + px < un.W) {
              const size_t ox = shuffle ? 2 * (size_t)(x0 + px) + ea.dx
                                        : (size_t)(x0 + px);
              // EPI_POOL stores t grouped (conv3x3.cuh), as the apply
              // loader reads it: channel co0 + 8 (e >> 1) is 8 (2 warp +
              // (e >> 1)) + g
              const size_t i =
                  EPI == EPI_POOL
                      ? ((size_t)(2 * warp + (e >> 1)) * un.H * un.W +
                         oy * ow + ox) * CG + g
                      : (oy * ow + ox) * C + co0 + 8 * (e >> 1);
              float v = acc[j][e];
              if constexpr (EPI == EPI_SKIP)
                v = __fadd_rn(v, __ldg(ea.skip + i));
              if constexpr (EPI == EPI_POOL) {
                if (e >> 1) s1 += v; else s0 += v;
              }
              out[i] = v;
            }
          }
        }
        if constexpr (EPI == EPI_POOL) {
          // the 4 lanes of a channel row hold its 128 columns
          s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 1);
          s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 2);
          s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 1);
          s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 2);
          pool0 += s0;
          pool1 += s1;
        }
      }
    }
    if constexpr (PROBE) tl.unit_end();
  }
  if constexpr (PROBE) tl.flush(probe, c, tid);
  if constexpr (EPI == EPI_POOL) {
    if (t == 0) {
      float* p = ea.pool + ((size_t)blockIdx.x * NCONS + c) * C;
      p[co0] = pool0;
      p[co0 + 8] = pool1;
    }
  }
}

template <int EPI, int LOAD, bool PROBE>
__device__ __forceinline__ void conv3x3(const float* __restrict__ in,
                                        float* __restrict__ out,
                                        const float* __restrict__ wl, int H,
                                        int W, const EpiArgs& ea,
                                        const LoadArgs& la, Probe* probe) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 128 + 1);         // producer threads + the tx arrival
      bar_init(&empty[s], 128 * NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Units un(H, W);
  const int wg = threadIdx.x / 128;
  if (wg == NCONS)
    producer<LOAD, PROBE>(in, wl, un, smem, full, empty, la, probe);
  else
    consumer<EPI, PROBE>(out, wl + W_LAYER, un, smem, full, empty, wg, ea,
                         probe);
}

template <bool PROBE>
__global__ void __launch_bounds__(NTHREADS, 1)
vdsr_conv3x3_kernel(const float* __restrict__ in, float* __restrict__ out,
                    const float* __restrict__ wl, int H, int W,
                    Probe* probe) {
  conv3x3<EPI_RELU, LOAD_PLAIN, PROBE>(in, out, wl, H, W, EpiArgs{},
                                       LoadArgs{}, probe);
}

template <int EPI, int LOAD, bool PROBE>
__global__ void __launch_bounds__(NTHREADS, 1)
rcan_conv3x3_kernel(const float* __restrict__ in, float* __restrict__ out,
                    const float* __restrict__ wl, int H, int W, EpiArgs ea,
                    LoadArgs la, Probe* probe) {
  conv3x3<EPI, LOAD, PROBE>(in, out, wl, H, W, ea, la, probe);
}

template <int LOAD>
constexpr size_t smem_bytes() {
  return LOAD == LOAD_PLAIN ? SMEM_BYTES : SMEM_APPLY_BYTES;
}

template <int EPI, int LOAD, bool PROBE>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(rcan_conv3x3_kernel<EPI, LOAD, PROBE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<LOAD>());
}

// The instance's probed twin where `probe` (its kind's record) is given.
template <int EPI, int LOAD>
cudaError_t launch(const float* in, float* out, const float* wl, int H,
                   int W, const EpiArgs& ea, const LoadArgs& la, int grid,
                   cudaStream_t s, Probe* probe) {
  if (probe != nullptr)
    rcan_conv3x3_kernel<EPI, LOAD, true>
        <<<grid, NTHREADS, smem_bytes<LOAD>(), s>>>(in, out, wl, H, W, ea, la,
                                                    probe);
  else
    rcan_conv3x3_kernel<EPI, LOAD, false>
        <<<grid, NTHREADS, smem_bytes<LOAD>(), s>>>(in, out, wl, H, W, ea, la,
                                                    nullptr);
  return cudaGetLastError();
}

// --- conv1 and conv20 on the SIMT units --------------------------------------

// Both walk a block's EDGE_PX consecutive pixels (row-major over the
// frame), a warp two pixels at a time: lane l takes pixel l / 16 of the
// pair and output (conv1) or input (conv20) channels 4 (l % 16) .. + 3, so
// that a warp's float4 accesses of an activation are 512 contiguous bytes.
// The weights: [9 taps][64] then 64 (conv1) or 1 (conv20) biases.
constexpr int EDGE_THREADS = 256;
constexpr int PAIRS = 8;                    // pixel pairs a warp walks
constexpr int EDGE_PX = EDGE_THREADS / 32 * 2 * PAIRS;   // 128 a block

// x = u8 / 255 for each of the 256 values, correctly rounded
__device__ __forceinline__ void x_table(float* xs) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    xs[i] = __fdiv_rn((float)i, 255.f);
}

// conv1 + ReLU; x zero outside the image.
__global__ void __launch_bounds__(EDGE_THREADS)
vdsr_first_kernel(const uint8_t* __restrict__ y, const float* __restrict__ w1,
                  float* __restrict__ out, int H, int W) {
  __shared__ float xs[256];
  x_table(xs);
  const int lane = threadIdx.x & 31, g = lane & 15;
  float4 w[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
    w[k] = __ldg(reinterpret_cast<const float4*>(w1) + k * (C / 4) + g);
  const float4 b = __ldg(reinterpret_cast<const float4*>(w1 + W_EDGE) + g);
  __syncthreads();
  const long long px = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * EDGE_PX +
                       (threadIdx.x >> 5) * 2 * PAIRS + (lane >> 4);
  for (int i = 0; i < PAIRS; ++i) {
    const long long p = p0 + 2 * i;
    if (p >= px) break;
    const int py = (int)p / W, pxl = (int)p - py * W;
    float4 a = b;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      const int gy = py + k / 3 - 1, gx = pxl + k % 3 - 1;
      const float x = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                          ? xs[__ldg(y + (size_t)gy * W + gx)]
                          : 0.f;
      a.x = fmaf(w[k].x, x, a.x);
      a.y = fmaf(w[k].y, x, a.y);
      a.z = fmaf(w[k].z, x, a.z);
      a.w = fmaf(w[k].w, x, a.w);
    }
    *reinterpret_cast<float4*>(out + p * C + 4 * g) =
        make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f),
                    fmaxf(a.w, 0.f));
  }
}

// conv20 + the residual and the store: Y' = clamp(rint(255 (x + f)), 0,
// 255); each lane sums its 4 channels over the 9 taps, then the 16 lanes
// of a pixel add theirs.
__global__ void __launch_bounds__(EDGE_THREADS)
vdsr_last_kernel(const float* __restrict__ act, const uint8_t* __restrict__ y,
                 const float* __restrict__ wl, uint8_t* __restrict__ out,
                 int H, int W) {
  __shared__ float xs[256];
  x_table(xs);
  const int lane = threadIdx.x & 31, g = lane & 15;
  float4 w[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
    w[k] = __ldg(reinterpret_cast<const float4*>(wl) + k * (C / 4) + g);
  const float bias = __ldg(wl + W_EDGE);
  __syncthreads();
  const long long px = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * EDGE_PX +
                       (threadIdx.x >> 5) * 2 * PAIRS + (lane >> 4);
  for (int i = 0; i < PAIRS; ++i) {
    const long long p = p0 + 2 * i;
    if (p - (lane >> 4) >= px) break;       // the pair's first pixel
    float acc = 0.f;
    if (p < px) {
      const int py = (int)p / W, pxl = (int)p - py * W;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const int gy = py + k / 3 - 1, gx = pxl + k % 3 - 1;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            act + ((size_t)gy * W + gx) * C) + g);
        acc = fmaf(v.x, w[k].x, acc);
        acc = fmaf(v.y, w[k].y, acc);
        acc = fmaf(v.z, w[k].z, acc);
        acc = fmaf(v.w, w[k].w, acc);
      }
    }
#pragma unroll
    for (int m = 8; m > 0; m >>= 1)
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, m);
    if (g == 0 && p < px) {
      const float f = __fadd_rn(acc, bias);
      const float v = rintf(__fmul_rn(__fadd_rn(xs[__ldg(y + p)], f), 255.f));
      out[p] = (uint8_t)fminf(fmaxf(v, 0.f), 255.f);
    }
  }
}

}  // namespace

// y: B planes of H x W u8, plane b at y + b * frame_stride (rows contiguous);
// out: B x H x W u8.  w_first: conv1 [9][64] + 64 biases; w_mid: DEPTH - 2
// packed 64->64 layers of LAYER_FLOATS each (16-byte aligned); w_last: conv20
// [9][64] + its bias.  act0, act1: two H x W x 64 float32 buffers, which the
// frames use in turn.  (grid, smem_bytes): ops/cuda_vdsr.py::vdsr_plan.
// Enqueues, frame by frame, conv1, the DEPTH - 2 middle layers and conv20
// on `stream`.  probes: the counter records (probe.cuh), or null; given,
// the middle layers run probed.
extern "C" int vdsr_y_u8(const uint8_t* y, long long frame_stride,
                         const float* w_first, const float* w_mid,
                         const float* w_last, float* act0, float* act1,
                         uint8_t* out, int B, int H, int W, int grid,
                         int smem_bytes, void* stream, void* probes) {
  if (smem_bytes != (int)SMEM_BYTES || grid <= 0 ||
      (reinterpret_cast<uintptr_t>(w_mid) & 15) != 0 ||
      (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;   // a plan for another kernel
  Probe* probe = probe_of(static_cast<Probe*>(probes), PROBE_VDSR);
  cudaError_t err = cudaFuncSetAttribute(
      probe != nullptr ? vdsr_conv3x3_kernel<true>
                       : vdsr_conv3x3_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long px = (long long)H * W;
  const int edge_blocks = (int)((px + EDGE_PX - 1) / EDGE_PX);
  for (int b = 0; b < B; ++b) {
    const uint8_t* yb = y + b * frame_stride;
    vdsr_first_kernel<<<edge_blocks, EDGE_THREADS, 0, s>>>(yb, w_first,
                                                          act0, H, W);
    float* src = act0;
    float* dst = act1;
    for (int l = 0; l < DEPTH - 2; ++l) {
      const float* wl = w_mid + (size_t)l * LAYER_FLOATS;
      if (probe != nullptr)
        vdsr_conv3x3_kernel<true><<<grid, NTHREADS, SMEM_BYTES, s>>>(
            src, dst, wl, H, W, probe);
      else
        vdsr_conv3x3_kernel<false><<<grid, NTHREADS, SMEM_BYTES, s>>>(
            src, dst, wl, H, W, nullptr);
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
    vdsr_last_kernel<<<edge_blocks, EDGE_THREADS, 0, s>>>(
        src, yb, w_last, out + b * px, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

namespace srcnn_hopper {

// RCAN's instances: every epilogue on the plain loader, an RCAB's first
// conv on LOAD_APPLY and a group's last conv on LOAD_APPLY_LAST.
template <bool PROBE>
int opt_in_all() {
  const cudaError_t errs[] = {
      opt_in<EPI_RELU, LOAD_PLAIN, PROBE>(),
      opt_in<EPI_POOL, LOAD_PLAIN, PROBE>(),
      opt_in<EPI_SKIP, LOAD_PLAIN, PROBE>(),
      opt_in<EPI_SHUFFLE, LOAD_PLAIN, PROBE>(),
      opt_in<EPI_RELU, LOAD_APPLY, PROBE>(),
      opt_in<EPI_SKIP, LOAD_APPLY_LAST, PROBE>()};
  for (const cudaError_t err : errs)
    if (err != cudaSuccess) return (int)err;
  return 0;
}

int rcan_conv3x3_prepare(bool probed) {
  const int err = opt_in_all<false>();
  return err != 0 || !probed ? err : opt_in_all<true>();
}

cudaError_t rcan_conv3x3(Epilogue epi, Loader load, const float* in,
                         float* out, const float* wl, int H, int W,
                         EpiArgs ea, LoadArgs la, int grid, cudaStream_t s,
                         Probe* probes) {
  if (load != LOAD_PLAIN && (la.parts <= 0 || la.parts > CA_PARTS_MAX))
    return cudaErrorInvalidValue;
  if (load == LOAD_PLAIN) {
    switch (epi) {
      case EPI_RELU:
        return launch<EPI_RELU, LOAD_PLAIN>(
            in, out, wl, H, W, ea, la, grid, s,
            probe_of(probes, PROBE_RCAN_RELU));
      case EPI_POOL:
        return launch<EPI_POOL, LOAD_PLAIN>(
            in, out, wl, H, W, ea, la, grid, s,
            probe_of(probes, PROBE_RCAN_POOL));
      case EPI_SKIP:
        return launch<EPI_SKIP, LOAD_PLAIN>(
            in, out, wl, H, W, ea, la, grid, s,
            probe_of(probes, PROBE_RCAN_SKIP));
      case EPI_SHUFFLE:
        return launch<EPI_SHUFFLE, LOAD_PLAIN>(
            in, out, wl, H, W, ea, la, grid, s,
            probe_of(probes, PROBE_RCAN_SHUFFLE));
    }
  }
  if (load == LOAD_APPLY && epi == EPI_RELU)
    return launch<EPI_RELU, LOAD_APPLY>(
        in, out, wl, H, W, ea, la, grid, s,
        probe_of(probes, PROBE_RCAN_RELU_APPLY));
  if (load == LOAD_APPLY_LAST && epi == EPI_SKIP)
    return launch<EPI_SKIP, LOAD_APPLY_LAST>(
        in, out, wl, H, W, ea, la, grid, s,
        probe_of(probes, PROBE_RCAN_SKIP_APPLY_LAST));
  return cudaErrorInvalidValue;   // an instance RCAN does not launch
}

}  // namespace srcnn_hopper
