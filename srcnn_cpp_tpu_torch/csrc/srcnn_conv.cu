// K1, K4, K5: the fused SRCNN 9-5-5 conv stack on Hopper's warpgroup MMA,
// one kernel template over its store (the epilogue).
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
// The three share one body, so they sum in the same order: quantized K5
// equals K1, and K4 equals K1 -> K3, bit for bit.
//
// What it computes, per output pixel (reference src/srcnn.cpp:189-325):
//   f1 = ReLU(conv1 9x9 1->64 (input replicate-padded by 4) + b1)
//   f2 = ReLU(conv2 1x1 64->32 (f1) + b2)
//   v  = conv3 5x5 32->1 (f2 replicate-padded by 2 at FEATURE level) + b3
// IntTrim(v) truncates toward zero, then clamps to [0, 255] before the u8
// cast.
//
// What bounds it on the H100: tensor-core issue.  In 3xTF32 the three
// stages take 18,912 MACs per output pixel (conv1 2 x 81 x 64, conv2
// 3 x 64 x 32, conv3 3 x 32 x 25) against 1 byte in and 1 to 4 bytes out.
//
// What the design does about it:
// * every stage is a GEMM over f2 positions on
//   wgmma.mma_async.m64nNk8.f32.tf32.tf32, A from registers, B (the
//   weights) from shared memory through matrix descriptors, fp32
//   accumulation.  fp32 accuracy comes from the 3xTF32 split: hi = x with
//   its low 13 bits cleared, lo = x - hi (exact in fp32, read as tf32), and
//   a*b ~ al*bh + ah*bl + ah*bh.  The u8 input is exact in tf32, so conv1
//   takes 2 products (x.w1lo + x.w1hi);
// * register fragments (PTX ISA, "Register Fragments and Shared Memory
//   Matrix Layouts" of wgmma, the .m64nNk8 tf32 A figure and the .m64nN
//   f32 D figure; CuTe's ALayout_64x8 / CLayout_64xN say the same): warp w
//   of a warpgroup holds rows 16w..16w+15, and within them thread
//   (g, t) = (lane / 4, lane % 4) holds A {(g, t), (g+8, t), (g, t+4),
//   (g+8, t+4)} of each k8 step and D {(g, 8j+2t), (g, 8j+2t+1),
//   (g+8, 8j+2t), (g+8, 8j+2t+1)} of each n8 column block j: a warp's
//   share is the m16n8k8 fragment.  So conv1's A fragments come straight from
//   the input window (im2col in registers), and each stage's accumulators
//   become the next stage's A fragments in registers (relu_split): D
//   columns 2t, 2t+1 feed K positions t, t+4, a permutation that the packed
//   w2 and w3 carry (ops/cuda_srcnn.py::c_to_a_perm), so no shuffle;
// * B in wgmma's canonical K-major layout with no swizzle: a core matrix
//   (8 rows of N x 16 bytes = 4 tf32 of K) is 128 contiguous bytes, so a
//   core-matrix read touches each of the 32 banks once.  Per k8 step the
//   N/8 x 2 core matrices lie in order (n-block, k-half): the leading byte
//   offset (next 4 K) is 128, the stride byte offset (next 8 N) 256;
// * a work unit is a strip of 60 output columns by a segment of rows: its
//   64 f2 columns (60 + the 2-column halo on each side) are one m64 tile,
//   and the unit walks down its f2 rows.  Per f2 row conv3 yields 25 tap
//   partials per position, the TPU kernel's form (pallas_srcnn.py:20-22);
//   they go into a ring of rows, and an output row's 25-tap stencil runs
//   once its 5 partial rows exist, so only a segment's interior ends
//   recompute rows (the plan makes segments as tall as the card's consumers
//   allow).  f2 is computed at feature coordinates clamped to the image on
//   both axes, the reference's conv3 feature clamp: edge rows are read
//   again from the ring, edge columns recomputed; conv1 reads its input at
//   clamped coordinates.  An output pixel's arithmetic never depends on
//   where its strip lies;
// * warp specialisation, one persistent block per SM: two consumer
//   warpgroups each run the wgmma chain conv1 -> conv2 -> conv3 of their own
//   unit, so one's waits between stages overlap the other's products; a
//   helper warpgroup holds one loader warp per consumer (input rows from
//   device memory, bytes to floats, into a ring) and one stencil warp per
//   consumer (the 25-tap sum in tap order, + b3, the store).  Hand-offs
//   go through mbarriers in shared memory; setmaxnreg moves registers from
//   the helper warpgroup to the consumers.  The loader uses plain loads:
//   it converts every byte to a float anyway, so a cp.async or TMA copy
//   would only add a staging buffer (and TMA's 16-byte stride rule would
//   refuse odd widths); running up to 7 rows ahead of its consumer hides
//   their latency.  The packed weights (hi/lo planes, 70 KB) are staged in
//   shared memory once per block.
//
// The plan (segment rows, strip width, grid, shared-memory bytes) is
// computed by ops/cuda_srcnn.py::conv_tile_plan and handed to the launcher,
// which refuses a plan that does not match the constants below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"

namespace {

constexpr int TW = 60;                      // output columns of a strip
constexpr int POS = TW + 4;                 // f2 positions of a strip row
constexpr int IW = TW + 12;                 // input window columns (72)
constexpr int IWS = 88;                     // float window row stride: a
                                            // tap row wrap (+IWS-8) lands
                                            // off the unwrapped lanes' banks
constexpr int RIN = 16;                     // input ring rows
constexpr int IN_ROWS = RIN + 8;            // + copies of rows 0..7, so the
                                            // 9 rows of conv1 never wrap
constexpr int RP = 8;                       // partial ring rows
constexpr int PSTR = POS + 4;               // partial plane stride (banks)
constexpr int PROW = 25 * PSTR;             // floats of one partial row
constexpr int NCONS = 2;                    // consumer warpgroups
constexpr int NTHREADS = 128 * (NCONS + 1); // + the helper warpgroup
constexpr int CONS_REGS = 224, HELP_REGS = 56;   // setmaxnreg split
static_assert(POS == 64, "a strip row is one m64 tile");
static_assert(NCONS * 128 * CONS_REGS + 128 * HELP_REGS <= 65536,
              "the register file");
static_assert((RIN & (RIN - 1)) == 0 && (RP & (RP - 1)) == 0, "rings");

// packed weight layout (floats); must match ops/cuda_srcnn.py::pack_weights.
// Each weight matrix [K][N] is two planes (tf32 hi, lo) in K-major core
// matrices: element (k, n) at ((s * N/8 + n/8) * 2 + (k%8)/4) * 32 +
// (n%8) * 4 + k%4, s = k/8 the k8 step.
constexpr int K1P = 88;                     // conv1 taps 81, padded to 88
constexpr int CORE = 32;                    // floats of one core matrix
constexpr int W1_PLANE = (K1P / 8) * (64 / 8) * 2 * CORE;
constexpr int W1H_OFF = 0, W1L_OFF = W1H_OFF + W1_PLANE;
constexpr int B1_OFF = W1L_OFF + W1_PLANE;
constexpr int W2_PLANE = (64 / 8) * (32 / 8) * 2 * CORE;   // K permuted
constexpr int W2H_OFF = B1_OFF + 64, W2L_OFF = W2H_OFF + W2_PLANE;
constexpr int B2_OFF = W2L_OFF + W2_PLANE;
constexpr int W3_PLANE = (32 / 8) * (32 / 8) * 2 * CORE;   // K permuted,
constexpr int W3H_OFF = B2_OFF + 32, W3L_OFF = W3H_OFF + W3_PLANE;  // N 25->32
constexpr int B3_OFF = W3L_OFF + W3_PLANE;  // [1], padded to 4
constexpr int WTOTAL = B3_OFF + 4;
static_assert(WTOTAL == 17508, "packed weight size");
static_assert(W1L_OFF == 5632 && B1_OFF == 11264 && W2H_OFF == 11328 &&
              W2L_OFF == 13376 && B2_OFF == 15424 && W3H_OFF == 15456 &&
              W3L_OFF == 16480 && B3_OFF == 17504,
              "packed layout (ops/cuda_srcnn.py::packed_layout)");
static_assert(W1H_OFF % 32 == 0 && W1L_OFF % 32 == 0 && W2H_OFF % 32 == 0 &&
              W2L_OFF % 32 == 0 && W3H_OFF % 32 == 0 && W3L_OFF % 32 == 0,
              "planes on 128-byte boundaries");
constexpr uint32_t LBO = 128, SBO = 256;    // descriptor byte offsets

constexpr int IN_OFF = (WTOTAL + 31) / 32 * 32;        // [NCONS][IN_ROWS][IWS]
constexpr int P_OFF = IN_OFF + NCONS * IN_ROWS * IWS;  // [NCONS][RP][PROW]
constexpr int BAR_OFF = P_OFF + NCONS * RP * PROW;     // mbarriers
constexpr int NBARS = 2 * RIN + 2 * RP;                // per consumer
constexpr size_t SMEM_BYTES = sizeof(float) * BAR_OFF + 8 * NCONS * NBARS;
static_assert(BAR_OFF % 2 == 0, "mbarrier alignment");
static_assert(SMEM_BYTES == 196608, "shared memory of the plan");
static_assert(SMEM_BYTES <= 232448, "one block's shared memory on sm_90");

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

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count) : "memory");
}

// Arrive (release: this thread's earlier shared-memory reads and writes are
// done before the phase can complete).
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

// Wait until the phase of parity `parity` has completed (acquire).
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// Ring slot n of a ring of size R: its barrier completes once per pass, so
// the k-th use waits for parity k & 1; the other side's first pass is free.
template <int R>
__device__ __forceinline__ uint32_t pass_parity(uint32_t n) {
  return (n / R) & 1u;
}

// --- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads and writes across the
// wgmma fences and waits (the registers change asynchronously).
template <int J>
__device__ __forceinline__ void fence_acc(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// Matrix descriptor of a K-major, unswizzled operand at shared address p:
// start >> 4 in bits 0-13, LBO >> 4 in 16-29, SBO >> 4 in 32-45, base
// offset 0, layout type 0 (no swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(LBO >> 4) << 16) | ((uint64_t)(SBO >> 4) << 32);
}

// D[64 x 64] += A[64 x 8] . B[8 x 64]; A in registers (tf32 bit patterns).
__device__ __forceinline__ void mma_n64(float (&d)[8][4],
                                        const uint32_t (&a)[4],
                                        uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D[64 x 32] += A[64 x 8] . B[8 x 32].
__device__ __forceinline__ void mma_n32(float (&d)[4][4],
                                        const uint32_t (&a)[4],
                                        uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// 3xTF32 split: hi keeps the tf32 bits of x; lo = x - hi is exact in fp32.
// A bit mask, not a cvt round trip, so the compiler cannot fold lo to 0.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// ReLU and split of one n8 column block of an accumulator, reordered into
// the A fragment of the next stage's k8 step: a = {c0, c2, c1, c3}.
__device__ __forceinline__ void relu_split(const float (&c)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(fmaxf(c[0], 0.f), hi[0], lo[0]);
  split(fmaxf(c[2], 0.f), hi[1], lo[1]);
  split(fmaxf(c[1], 0.f), hi[2], lo[2]);
  split(fmaxf(c[3], 0.f), hi[3], lo[3]);
}

// Window offset of conv1 tap k (row-major ky * 9 + kx); padded taps read
// the window's origin, which their zero weights cancel.
__device__ __forceinline__ int tap_offset(int k) {
  return k < 81 ? (k / 9) * IWS + k % 9 : 0;
}

// --- work units --------------------------------------------------------------

// Unit u: frame b, output rows [r0, r1), output columns [x0, x0 + TW)
// clipped to the image; f2 rows [f_lo, f_hi] of the image (its stencil's
// reach), input rows f_lo - 4 .. f_hi + 4 (clamped when read).
struct Unit {
  int b, r0, r1, x0, f_lo, f_hi;
};

struct Geometry {
  int H, W, seg_h, sx_n, seg_n, units;

  __device__ Geometry(int B, int H_, int W_, int seg_h_)
      : H(H_), W(W_), seg_h(seg_h_), sx_n((W_ + TW - 1) / TW),
        seg_n((H_ + seg_h_ - 1) / seg_h_), units(B * sx_n * seg_n) {}

  __device__ Unit unit(int u) const {
    const int sx = u % sx_n, rest = u / sx_n;
    Unit t;
    t.b = rest / seg_n;
    t.r0 = (rest % seg_n) * seg_h;
    t.r1 = min(t.r0 + seg_h, H);
    t.x0 = sx * TW;
    t.f_lo = max(t.r0 - 2, 0);
    t.f_hi = min(t.r1 + 1, H - 1);
    return t;
  }
};

// Consumer c of block k takes units k + (c + NCONS i) * grid, i = 0, 1, ...:
// the blocks fill first, then each block's second consumer.
#define FOR_UNITS(u, c, geo) \
  for (int u = blockIdx.x + (c) * gridDim.x; u < (geo).units; \
       u += NCONS * gridDim.x)

struct Rings {
  float* in;          // [IN_ROWS][IWS] input rows as floats
  float* part;        // [RP][25][PSTR] conv3 tap partials
  uint64_t* in_full;  // [RIN] loader -> consumer (32 arrivals)
  uint64_t* in_free;  // [RIN] consumer -> loader (128 arrivals)
  uint64_t* p_full;   // [RP] consumer -> stencil (128 arrivals)
  uint64_t* p_free;   // [RP] stencil -> consumer (32 arrivals)

  __device__ Rings(float* smem, int c) {
    in = smem + IN_OFF + c * IN_ROWS * IWS;
    part = smem + P_OFF + c * RP * PROW;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF) + c * NBARS;
    in_full = bars;
    in_free = bars + RIN;
    p_full = bars + 2 * RIN;
    p_free = bars + 2 * RIN + RP;
  }
};

// --- loader warp: input rows of its consumer's units, in order ---------------

__device__ __forceinline__ void loader(const uint8_t* __restrict__ y,
                                       long long frame_stride,
                                       const Geometry& geo, const Rings& r,
                                       int c, int lane) {
  uint32_t n = 0;   // input rows handed over so far
  FOR_UNITS(u, c, geo) {
    const Unit t = geo.unit(u);
    const uint8_t* src = y + (size_t)t.b * frame_stride;
    for (int v = t.f_lo - 4; v <= t.f_hi + 4; ++v, ++n) {
      const int s = n & (RIN - 1);
      bar_wait(&r.in_free[s], pass_parity<RIN>(n) ^ 1u);
      const uint8_t* row = src + (size_t)min(max(v, 0), geo.H - 1) * geo.W;
      float* dst = r.in + s * IWS;
      for (int col = lane; col < IW; col += 32) {
        const float f =
            (float)__ldg(row + min(max(t.x0 - 6 + col, 0), geo.W - 1));
        dst[col] = f;
        if (s < IN_ROWS - RIN) dst[RIN * IWS + col] = f;
      }
      bar_arrive(&r.in_full[s]);
    }
  }
}

// --- stencil warp: the 25-tap sum of its consumer's partial rows, the store --

template <class Store>
__device__ __forceinline__ void stencil(const Geometry& geo, const Rings& r,
                                        float b3, const Store& store, int c,
                                        int lane) {
  uint32_t n = 0;   // partial rows of earlier units
  FOR_UNITS(u, c, geo) {
    const Unit t = geo.unit(u);
    int freed = t.f_lo;
    for (int oy = t.r0; oy < t.r1; ++oy) {
      const uint32_t newest = n + min(oy + 2, geo.H - 1) - t.f_lo;
      bar_wait(&r.p_full[newest & (RP - 1)], pass_parity<RP>(newest));
      const float* rows[5];
#pragma unroll
      for (int dy = 0; dy < 5; ++dy) {
        const uint32_t q = n + min(max(oy - 2 + dy, 0), geo.H - 1) - t.f_lo;
        rows[dy] = r.part + (q & (RP - 1)) * PROW;
      }
      for (int col = lane; col < TW; col += 32) {
        if (t.x0 + col >= geo.W) break;
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 5; ++dy)
#pragma unroll
          for (int dx = 0; dx < 5; ++dx)
            acc += rows[dy][(dy * 5 + dx) * PSTR + col + dx];
        store(t.b, oy, t.x0 + col, geo.H, geo.W, acc + b3);
      }
      // rows below the next output row's reach go back to the consumer
      const int keep = oy + 1 < t.r1 ? max(oy - 1, 0) : t.f_hi + 1;
      for (; freed < keep; ++freed)
        bar_arrive(&r.p_free[(n + freed - t.f_lo) & (RP - 1)]);
    }
    n += t.f_hi - t.f_lo + 1;
  }
}

// --- consumer warpgroup: conv1 -> conv2 -> conv3 partials per f2 row ---------

// conv1's A fragments of the f2 row whose 9 input rows start at ring entry
// n: thread (g, t) of warp w gathers rows 16w+g and 16w+g+8 (window columns
// cb0, cb1) at taps 8s+t and 8s+t+4 of each k8 step s; then frees the
// window's first row, which the next f2 row no longer reads.
__device__ __forceinline__ void load_conv1_a(uint32_t (&a)[K1P / 8][4],
                                             const Rings& r, uint32_t n,
                                             int cb0, int cb1, int t) {
  const uint32_t last = n + 8;
  bar_wait(&r.in_full[last & (RIN - 1)], pass_parity<RIN>(last));
  const float* win = r.in + (n & (RIN - 1)) * IWS;
#pragma unroll
  for (int s = 0; s < K1P / 8; ++s) {
    const int o0 = tap_offset(8 * s + t), o1 = tap_offset(8 * s + t + 4);
    a[s][0] = __float_as_uint(win[cb0 + o0]);
    a[s][1] = __float_as_uint(win[cb1 + o0]);
    a[s][2] = __float_as_uint(win[cb0 + o1]);
    a[s][3] = __float_as_uint(win[cb1 + o1]);
  }
  bar_arrive(&r.in_free[n & (RIN - 1)]);
}

__device__ __forceinline__ void consumer(const float* ws, const Geometry& geo,
                                         const Rings& r, int c) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint64_t d1h = b_desc(ws + W1H_OFF), d1l = b_desc(ws + W1L_OFF);
  const uint64_t d2h = b_desc(ws + W2H_OFF), d2l = b_desc(ws + W2L_OFF);
  const uint64_t d3h = b_desc(ws + W3H_OFF), d3l = b_desc(ws + W3L_OFF);
  // a k8 step of an N-column plane is N * 8 floats: N * 32 bytes, >> 4
  constexpr uint64_t STEP1 = 64 * 32 / 16, STEP23 = 32 * 32 / 16;

  uint32_t n_in = 0, n_part = 0;   // ring entries of earlier units
  FOR_UNITS(u, c, geo) {
    const Unit tl = geo.unit(u);
    // window column of position m's first tap: f2 column clamp(x0-2+m)
    // reads input columns clamp(...) - 4 .. + 4; window column c holds
    // input column clamp(x0 - 6 + c)
    const int m0 = 16 * warp + g;
    const int cb0 = min(max(tl.x0 - 2 + m0, 0), geo.W - 1) - tl.x0 + 2;
    const int cb1 = min(max(tl.x0 + 6 + m0, 0), geo.W - 1) - tl.x0 + 2;
    const int rows = tl.f_hi - tl.f_lo + 1;

    uint32_t a1[K1P / 8][4], a1n[K1P / 8][4];
    load_conv1_a(a1, r, n_in, cb0, cb1, t);
    for (int i = 0; i < rows; ++i) {
      // conv1: 11 k8 steps x (x . w1lo + x . w1hi), from b1
      float acc1[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb =
            *reinterpret_cast<const float2*>(ws + B1_OFF + 8 * j + 2 * t);
        acc1[j][0] = bb.x; acc1[j][1] = bb.y;
        acc1[j][2] = bb.x; acc1[j][3] = bb.y;
      }
      fence_acc(acc1);
      wg_fence();
#pragma unroll
      for (int s = 0; s < K1P / 8; ++s) {
        mma_n64(acc1, a1[s], d1l + s * STEP1);
        mma_n64(acc1, a1[s], d1h + s * STEP1);
      }
      wg_commit();
      // the next row's A fragments load while these products run
      if (i + 1 < rows) load_conv1_a(a1n, r, n_in + i + 1, cb0, cb1, t);
      wg_wait_all();
      fence_acc(acc1);

      // conv2: f1 = ReLU(acc1) split into A fragments; al.bh + ah.bl + ah.bh
      uint32_t ah[8][4], al[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) relu_split(acc1[j], ah[j], al[j]);
      float acc2[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 bb =
            *reinterpret_cast<const float2*>(ws + B2_OFF + 8 * j + 2 * t);
        acc2[j][0] = bb.x; acc2[j][1] = bb.y;
        acc2[j][2] = bb.x; acc2[j][3] = bb.y;
      }
      fence_acc(acc2);
      wg_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        mma_n32(acc2, al[s], d2h + s * STEP23);
        mma_n32(acc2, ah[s], d2l + s * STEP23);
        mma_n32(acc2, ah[s], d2h + s * STEP23);
      }
      wg_commit();
      wg_wait_all();
      fence_acc(acc2);

      // conv3 per-tap partials: P = ReLU(acc2) . W3, 3 products
      uint32_t bh[4][4], bl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) relu_split(acc2[j], bh[j], bl[j]);
      float acc3[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc3[j][e] = 0.f;
      fence_acc(acc3);
      wg_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        mma_n32(acc3, bl[s], d3h + s * STEP23);
        mma_n32(acc3, bh[s], d3l + s * STEP23);
        mma_n32(acc3, bh[s], d3h + s * STEP23);
      }
      wg_commit();
      wg_wait_all();
      fence_acc(acc3);

      // the partial row into its ring slot, once the stencil is done with it
      const uint32_t p = n_part + i;
      bar_wait(&r.p_free[p & (RP - 1)], pass_parity<RP>(p) ^ 1u);
      float* part = r.part + (p & (RP - 1)) * PROW;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tap = 8 * j + 2 * t;
        if (tap < 25) {
          part[tap * PSTR + m0] = acc3[j][0];
          part[tap * PSTR + m0 + 8] = acc3[j][2];
        }
        if (tap + 1 < 25) {
          part[(tap + 1) * PSTR + m0] = acc3[j][1];
          part[(tap + 1) * PSTR + m0 + 8] = acc3[j][3];
        }
      }
      bar_arrive(&r.p_full[p & (RP - 1)]);
#pragma unroll
      for (int s = 0; s < K1P / 8; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) a1[s][e] = a1n[s][e];
    }
    // the last f2 row's window: its 8 rows past the first go back too
    for (uint32_t q = n_in + rows; q < n_in + rows + 8; ++q)
      bar_arrive(&r.in_free[q & (RIN - 1)]);
    n_in += rows + 8;
    n_part += rows;
  }
}

template <class Store>
__global__ void __launch_bounds__(NTHREADS, 1)
srcnn_conv_kernel(const uint8_t* __restrict__ y, long long frame_stride,
                  const float* __restrict__ wpack, int B, int H, int W,
                  int seg_h, Store store) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const float4* wp4 = reinterpret_cast<const float4*>(wpack);
  for (int i = threadIdx.x; i < WTOTAL / 4; i += NTHREADS) smem4[i] = wp4[i];
  if (threadIdx.x == 0) {
    for (int c = 0; c < NCONS; ++c) {
      const Rings r(smem, c);
      for (int s = 0; s < RIN; ++s) {
        bar_init(&r.in_full[s], 32);
        bar_init(&r.in_free[s], 128);
      }
      for (int s = 0; s < RP; ++s) {
        bar_init(&r.p_full[s], 128);
        bar_init(&r.p_free[s], 32);
      }
    }
  }
  // the weights were written through the generic proxy; wgmma reads them
  // through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const Geometry geo(B, H, W, seg_h);
  const int wg = threadIdx.x / 128;
  if (wg == NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(HELP_REGS));
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int c = warp % NCONS;
    if (warp < NCONS) {
      loader(y, frame_stride, geo, Rings(smem, c), c, lane);
    } else {
      stencil(geo, Rings(smem, c), smem[B3_OFF], store, c, lane);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS));
    consumer(smem, geo, Rings(smem, wg), wg);
  }
}

template <class Store>
int launch(const uint8_t* y, long long frame_stride, const float* wpack,
           int B, int H, int W, int tile_h, int tile_w, int grid,
           int smem_bytes, Store store, void* stream) {
  if (tile_w != TW || tile_h <= 0 || smem_bytes != (int)SMEM_BYTES ||
      grid <= 0)
    return (int)cudaErrorInvalidValue;   // a plan for another kernel
  cudaError_t err = cudaFuncSetAttribute(
      srcnn_conv_kernel<Store>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  srcnn_conv_kernel<Store><<<grid, NTHREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(y, frame_stride, wpack,
                                                     B, H, W, tile_h, store);
  return (int)cudaGetLastError();
}

}  // namespace

// y: B planes of H x W u8, plane b at y + b * frame_stride (rows contiguous);
// wpack: WTOTAL floats on the device, 16-byte aligned; out: B x H x W.
// (tile_h, tile_w, grid, smem_bytes): ops/cuda_srcnn.py::conv_tile_plan
// (tile_h: rows of a segment, tile_w: columns of a strip).
extern "C" int srcnn_conv_u8(const uint8_t* y, long long frame_stride,
                             const float* wpack, uint8_t* out, int B, int H,
                             int W, int tile_h, int tile_w, int grid,
                             int smem_bytes, void* stream) {
  return launch(y, frame_stride, wpack, B, H, W, tile_h, tile_w, grid,
                smem_bytes, StoreU8{out}, stream);
}

extern "C" int srcnn_conv_f32(const uint8_t* y, long long frame_stride,
                              const float* wpack, float* out, int B, int H,
                              int W, int tile_h, int tile_w, int grid,
                              int smem_bytes, void* stream) {
  return launch(y, frame_stride, wpack, B, H, W, tile_h, tile_w, grid,
                smem_bytes, StoreF32{out}, stream);
}

// up, out: B x 3 x H x W u8, contiguous; Y is read from up[:, 0].
extern "C" int srcnn_conv_merge_u8(const uint8_t* up, const float* wpack,
                                   uint8_t* out, int B, int H, int W,
                                   int tile_h, int tile_w, int grid,
                                   int smem_bytes, void* stream) {
  return launch(up, 3LL * H * W, wpack, B, H, W, tile_h, tile_w, grid,
                smem_bytes, StoreBGR{up, out}, stream);
}
