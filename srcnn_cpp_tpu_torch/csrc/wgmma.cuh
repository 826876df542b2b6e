// Hopper building blocks shared by the conv kernels: mbarriers in shared
// memory, warpgroup MMA (wgmma) fences and waits, the matrix descriptor of
// an unswizzled K-major operand, and the 3xTF32 split.
//
// Shared by K1/K4/K5 (srcnn_conv.cu) and the VDSR chain (vdsr_conv.cu), so
// the two split, order and describe their operands alike; the Python side
// of the same layout is ops/cuda_srcnn.py (tf32_split, _k_major,
// smem_descriptor).

#pragma once

#include <stdint.h>

namespace srcnn_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------------

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
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait_all() { wg_wait<0>(); }

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
// start >> 4 in bits 0-13, lbo >> 4 (the byte offset between core matrices
// along K) in 16-29, sbo >> 4 (along M or N) in 32-45, base offset 0,
// layout type 0 (no swizzle) in bits 62-63.  A core matrix is 8 rows of 16
// bytes, 128 contiguous bytes.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// 3xTF32 split: hi keeps the tf32 bits of x; lo = x - hi is exact in fp32.
// A bit mask, not a cvt round trip, so the compiler cannot fold lo to 0.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

}  // namespace srcnn_hopper
