// Stall counters of the two warp-specialised GEMM bodies: swinir.cu's gemm
// and vdsr_conv.cu's conv3x3.  Their PROBE = true instances keep them; the
// launchers pick those while a torch.profiler session records
// (utils/profiling.py::counter_records), and the PROBE = false instances
// take no stamp and compile as they did without this header.
//
// One record a GEMM kind (ProbeKind; ops/cuda_swinir.py::PROBE_KINDS and
// PROBE_FIELDS name the kinds and fields in the same order), summed over
// every launch since the caller last reset it.  The consumers' counts are
// those of thread 0 of each consumer warpgroup, so their cycles are summed
// over the block's two warpgroups; the producer's are those of its thread
// PROBE_PRODUCER_TID (its thread 0 also issues the bulk copies).  A thread
// tallies a launch in 32-bit registers (a block's tally of one launch stays
// under 2^32 cycles, 2.4 s at 1.755 GHz) and adds it to the record at its
// exit, one atomicAdd a field.  A stage costs no stamp unless a wait waits.

#pragma once

#include <stdint.h>

#include "wgmma.cuh"

namespace srcnn_hopper {

struct Probe {
  unsigned long long launches;           // by block 0
  // the consumers
  unsigned long long units;              // once a unit
  unsigned long long unit_cycles;        // the unit's first wait on full ..
                                         // the end of its epilogue
  unsigned long long full_wait_cycles;   // inside bar_wait(full)
  unsigned long long epilogue_cycles;    // the last stage's wg_wait .. the
                                         // tile staged (SwinIR) or stored
  // the producer
  unsigned long long stages;             // once a stage filled
  unsigned long long fill_cycles;        // its cycles not waiting on empty
  unsigned long long empty_wait_cycles;  // inside bar_wait(empty)
};

enum ProbeKind : int {
  // swinir.cu's GEMM body
  PROBE_QKV, PROBE_PROJ, PROBE_FC1, PROBE_FC2,
  PROBE_CONV,                            // the 180->180 convs
  PROBE_BEFORE_UP,                       // conv_before_upsample
  // vdsr_conv.cu's 64->64 body, an instance each
  PROBE_VDSR,                            // vdsr_conv3x3_kernel
  PROBE_RCAN_RELU, PROBE_RCAN_POOL, PROBE_RCAN_SKIP, PROBE_RCAN_SHUFFLE,
  PROBE_RCAN_RELU_APPLY, PROBE_RCAN_SKIP_APPLY_LAST,
  PROBE_KINDS
};

// Kind k's record in the table, or null for an unprobed call.
inline Probe* probe_of(Probe* table, int k) {
  return table == nullptr ? nullptr : table + k;
}

constexpr int PROBE_PRODUCER_TID = 32;

__device__ __forceinline__ uint32_t clock32() {
  return (uint32_t)clock64();
}

// Whether the phase of parity `parity` of b has completed, without waiting
// (acquire, where it has).
__device__ __forceinline__ bool bar_test(uint64_t* b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
  return done != 0;
}

// bar_wait, adding to `cycles` the cycles it spins.  The clock is read only
// where the phase has not completed at a first test, so that a wait that
// does not wait costs no stamp.  On an H100, a stamp before and after every
// wait of the producer, which paces that body, slowed conv_before_upsample
// by 22 %, stamps on every stage by 4 %; these cost it nothing, and the
// 1-tap linears 1-2 % (PERF.md, section 6).
__device__ __forceinline__ void bar_wait_timed(uint64_t* b, uint32_t parity,
                                               uint32_t& cycles) {
  if (bar_test(b, parity)) return;
  const uint32_t t0 = clock32();
  bar_wait(b, parity);
  cycles += clock32() - t0;
}

// A consumer thread's tally of one launch: the waits on full, and three
// stamps a unit.
struct ConsumerTally {
  uint32_t units = 0, unit = 0, full_wait = 0, epilogue = 0;
  uint32_t t_unit = 0, t = 0;

  // the wait on full of stage k of a unit, whose first starts the unit
  __device__ __forceinline__ void wait_full(uint64_t* b, uint32_t parity,
                                            int k) {
    if (k == 0) t_unit = clock32();
    bar_wait_timed(b, parity, full_wait);
  }
  // after the last stage's wg_wait
  __device__ __forceinline__ void epilogue_start() { t = clock32(); }
  __device__ __forceinline__ void unit_end() {
    const uint32_t e = clock32();
    epilogue += e - t;
    unit += e - t_unit;
    ++units;
  }
  // at the exit, by consumer warpgroup c's thread 0 (tid in it)
  __device__ __forceinline__ void flush(Probe* p, int c, int tid) const {
    if (tid != 0) return;
    atomicAdd(&p->unit_cycles, (unsigned long long)unit);
    atomicAdd(&p->full_wait_cycles, (unsigned long long)full_wait);
    atomicAdd(&p->epilogue_cycles, (unsigned long long)epilogue);
    if (c == 0) {
      atomicAdd(&p->units, (unsigned long long)units);
      if (blockIdx.x == 0) atomicAdd(&p->launches, 1ull);
    }
  }
};

// The producer thread's tally of one launch: the waits on empty, and its
// cycles from its start to its exit; the rest of those are its fills.
struct ProducerTally {
  uint32_t empty_wait = 0, t = 0;

  __device__ __forceinline__ void start() { t = clock32(); }
  __device__ __forceinline__ void wait_empty(uint64_t* b, uint32_t parity) {
    bar_wait_timed(b, parity, empty_wait);
  }
  // at the exit, by the producer warpgroup's thread PROBE_PRODUCER_TID,
  // with the stages it filled
  __device__ __forceinline__ void flush(Probe* p, uint32_t stages,
                                        int tid) const {
    const uint32_t fill = clock32() - t - empty_wait;
    if (tid != PROBE_PRODUCER_TID) return;
    atomicAdd(&p->stages, (unsigned long long)stages);
    atomicAdd(&p->fill_cycles, (unsigned long long)fill);
    atomicAdd(&p->empty_wait_cycles, (unsigned long long)empty_wait);
  }
};

}  // namespace srcnn_hopper
